"""ctypes bindings for the native content pipeline (port of
rtrt_tpu/content/native.py).

The C++ twin of the python content modules is this package's own copy,
`native/rtrt_native.cpp`.  It is built at first use with the host C++
compiler (the flags of the JAX package's native Makefile:
``-O2 -fPIC -std=c++17 -shared``) into ``build/rtrt_tpu_torch/`` at the
repository root, under a file name keyed by a hash of the source and
flags, and loaded from there only.  Where no compiler is found or the
build fails, `available()` is False and every entry point returns None, so
the callers take their numpy twins (host-side content generation: the
same tables either way, tests/test_torch_scene_bvh.py).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "native" / "rtrt_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "rtrt_tpu_torch"
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared")

_LIB = None
_TRIED = False


def _build():
    """Compile SOURCE into the hashed shared library (once); None when no
    C++ compiler is found or the build fails."""
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        return None
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(SOURCE.read_bytes())
    out = BUILD_DIR / f"librtrt_native_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, out)
    return out


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = _build()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        _LIB = None
        return None
    c = ctypes
    fp = c.POINTER(c.c_float)
    ip = c.POINTER(c.c_int32)
    i64p = c.POINTER(c.c_int64)
    lib.rtrt_free.argtypes = [c.c_void_p]
    lib.rtrt_perlin_fbm3.argtypes = [c.POINTER(c.c_double), c.c_int64,
                                     c.c_uint32, c.c_int, c.c_double,
                                     c.c_double, fp]
    lib.rtrt_terrain_density.argtypes = [c.c_int, c.c_int, c.c_int,
                                         c.c_double, c.c_double, c.c_double,
                                         c.c_uint32, c.c_double, fp]
    lib.rtrt_march_tetrahedra.argtypes = [fp, c.c_int, c.c_int, c.c_int,
                                          c.c_double, c.c_double, c.c_double,
                                          c.c_double, c.POINTER(fp), i64p]
    lib.rtrt_weld.argtypes = [fp, c.c_int64, c.c_double, c.POINTER(fp), i64p,
                              c.POINTER(ip), i64p]
    lib.rtrt_smooth_normals.argtypes = [fp, c.c_int64, ip, c.c_int64, fp]
    lib.rtrt_load_obj.argtypes = [c.c_char_p, c.POINTER(fp), i64p,
                                  c.POINTER(ip), i64p]
    lib.rtrt_load_obj.restype = c.c_int
    lib.rtrt_subdivide_loop.argtypes = [fp, c.c_int64, ip, c.c_int64, c.c_int,
                                        c.POINTER(fp), i64p, c.POINTER(ip),
                                        i64p]
    lib.rtrt_morton_sort_tris.argtypes = [fp, c.c_int64]
    lib.rtrt_build_sah.argtypes = [fp, c.c_int64, c.POINTER(fp),
                                   c.POINTER(ip), c.POINTER(ip), i64p]
    lib.rtrt_build_sah4.argtypes = [fp, c.c_int64, c.POINTER(fp),
                                    c.POINTER(ip), i64p]
    lib.rtrt_collapse4.argtypes = [fp, ip, c.c_int64, c.POINTER(fp), i64p]
    _LIB = lib
    return lib


def available() -> bool:
    return _load() is not None


def _take_f32(lib, ptr, count):
    arr = np.ctypeslib.as_array(ptr, shape=(count,)).copy()
    lib.rtrt_free(ptr)
    return arr


def _take_i32(lib, ptr, count):
    arr = np.ctypeslib.as_array(ptr, shape=(count,)).copy()
    lib.rtrt_free(ptr)
    return arr


def terrain_density(nx, ny, nz, origin, seed, height_scale):
    """Native corner-lattice density; None if the library is absent."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty((nx + 1) * (ny + 1) * (nz + 1), np.float32)
    lib.rtrt_terrain_density(nx, ny, nz, origin[0], origin[1], origin[2],
                             seed, height_scale,
                             out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out.reshape(nx + 1, ny + 1, nz + 1)


def march_tetrahedra(density, origin, scale=1.0):
    lib = _load()
    if lib is None:
        return None
    d = np.ascontiguousarray(density, np.float32)
    nx, ny, nz = d.shape[0] - 1, d.shape[1] - 1, d.shape[2] - 1
    tris = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_int64()
    lib.rtrt_march_tetrahedra(
        d.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), nx, ny, nz,
        origin[0], origin[1], origin[2], scale, ctypes.byref(tris),
        ctypes.byref(n))
    soup = _take_f32(lib, tris, n.value * 9).reshape(n.value, 3, 3)
    return soup[:, 0], soup[:, 1], soup[:, 2]


def weld(v0, v1, v2, tol=1e-3):
    lib = _load()
    if lib is None:
        return None
    soup = np.ascontiguousarray(
        np.stack([v0, v1, v2], axis=1), np.float32)
    n = soup.shape[0]
    verts = ctypes.POINTER(ctypes.c_float)()
    nv = ctypes.c_int64()
    idx = ctypes.POINTER(ctypes.c_int32)()
    nt = ctypes.c_int64()
    lib.rtrt_weld(soup.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n, tol,
                  ctypes.byref(verts), ctypes.byref(nv), ctypes.byref(idx),
                  ctypes.byref(nt))
    return (_take_f32(lib, verts, nv.value * 3).reshape(-1, 3),
            _take_i32(lib, idx, nt.value * 3).reshape(-1, 3))


def smooth_normals(vertices, indices):
    lib = _load()
    if lib is None:
        return None
    v = np.ascontiguousarray(vertices, np.float32)
    f = np.ascontiguousarray(indices, np.int32)
    out = np.empty_like(v)
    lib.rtrt_smooth_normals(
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), v.shape[0],
        f.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), f.shape[0],
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out


def load_obj(path):
    lib = _load()
    if lib is None:
        return None
    verts = ctypes.POINTER(ctypes.c_float)()
    nv = ctypes.c_int64()
    idx = ctypes.POINTER(ctypes.c_int32)()
    nt = ctypes.c_int64()
    if lib.rtrt_load_obj(path.encode(), ctypes.byref(verts), ctypes.byref(nv),
                         ctypes.byref(idx), ctypes.byref(nt)) != 0:
        raise FileNotFoundError(path)
    return (_take_f32(lib, verts, nv.value * 3).reshape(-1, 3),
            _take_i32(lib, idx, nt.value * 3).reshape(-1, 3))


def subdivide_loop(vertices, indices, levels=1):
    lib = _load()
    if lib is None:
        return None
    v = np.ascontiguousarray(vertices, np.float32)
    f = np.ascontiguousarray(indices, np.int32)
    verts = ctypes.POINTER(ctypes.c_float)()
    nv = ctypes.c_int64()
    idx = ctypes.POINTER(ctypes.c_int32)()
    nt = ctypes.c_int64()
    lib.rtrt_subdivide_loop(
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), v.shape[0],
        f.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), f.shape[0], levels,
        ctypes.byref(verts), ctypes.byref(nv), ctypes.byref(idx),
        ctypes.byref(nt))
    return (_take_f32(lib, verts, nv.value * 3).reshape(-1, 3),
            _take_i32(lib, idx, nt.value * 3).reshape(-1, 3))


def morton_sort_tris(v0, v1, v2):
    """In-place 63-bit morton reorder of a triangle soup (mesh baker)."""
    lib = _load()
    if lib is None:
        return None
    soup = np.ascontiguousarray(np.stack([v0, v1, v2], axis=1), np.float32)
    lib.rtrt_morton_sort_tris(
        soup.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), soup.shape[0])
    return soup[:, 0], soup[:, 1], soup[:, 2]


def build_sah(tris):
    """Binned-SAH flat BVH over a (n, 9) triangle soup (n >= 2).

    Returns (boxes (m,12) f32, children (m,2) i32 packed entries,
    perm (n,) i32 sorted-slot -> input index) or None if the library is
    absent (bvh/sah.py has the pure-numpy fallback).  Node/entry layout
    documented at rtrt_native.cpp::rtrt_build_sah.
    """
    lib = _load()
    if lib is None:
        return None
    soup = np.ascontiguousarray(tris, np.float32)
    n = soup.shape[0]
    assert soup.shape == (n, 9) and n >= 2, soup.shape
    boxes = ctypes.POINTER(ctypes.c_float)()
    children = ctypes.POINTER(ctypes.c_int32)()
    perm = ctypes.POINTER(ctypes.c_int32)()
    m = ctypes.c_int64()
    lib.rtrt_build_sah(
        soup.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n,
        ctypes.byref(boxes), ctypes.byref(children), ctypes.byref(perm),
        ctypes.byref(m))
    return (_take_f32(lib, boxes, m.value * 12).reshape(m.value, 12),
            _take_i32(lib, children, m.value * 2).reshape(m.value, 2),
            _take_i32(lib, perm, n))


def build_sah4(tris):
    """4-wide SAH BVH (binary binned-SAH build + greedy collapse).

    Returns (nodes (q,32) f32 records, perm (n,) i32) or None if the
    library is absent.  Record layout documented at
    rtrt_native.cpp::rtrt_build_sah4 (24 box floats, 4 child entries as
    exact f32, 4 pad lanes).
    """
    lib = _load()
    if lib is None:
        return None
    soup = np.ascontiguousarray(tris, np.float32)
    n = soup.shape[0]
    assert soup.shape == (n, 9) and n >= 2, soup.shape
    nodes = ctypes.POINTER(ctypes.c_float)()
    perm = ctypes.POINTER(ctypes.c_int32)()
    q = ctypes.c_int64()
    lib.rtrt_build_sah4(
        soup.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n,
        ctypes.byref(nodes), ctypes.byref(perm), ctypes.byref(q))
    return (_take_f32(lib, nodes, q.value * 32).reshape(q.value, 32),
            _take_i32(lib, perm, n))
