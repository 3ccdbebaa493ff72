"""Carry the JAX package's scene, sky, camera and exposure state into the
port.  There are no learned weights; the state that crosses is tables.

Every function takes the JAX package's structures (any object whose fields
convert with `numpy.asarray`, e.g. jax arrays) and returns the port's
dataclasses of torch tensors.  This module imports neither jax nor any JAX
module: the conversion goes through numpy, so tests can feed both packages
identical inputs.  Like every entry point of the port, the converters put
the tables on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..bvh.packet import TraceTables, pack_tables, pack_tables_sah2
from ..bvh.types import SceneBvh
from ..core.camera import Camera
from ..render.bsdf import Materials
from ..render.ftex import FourierTexture, FourierTextures
from ..render.light import SphereLights
from ..render.sky import SkyMaps, SkyParams


def _t(x, device="cuda", dtype=None):
    a = np.array(np.asarray(x), copy=True)
    t = torch.from_numpy(a).to(device)
    return t if dtype is None else t.to(dtype)


def bvh_from_jax(bvh, device="cuda") -> SceneBvh:
    return SceneBvh(*(_t(getattr(bvh, f), device) for f in (
        "boxes_t", "children_t", "tris_t", "sorted_tri_index", "root_lo",
        "root_hi")))


def trace_tables_from_jax(bvh, tri_nrm_t, sorted_mat, nodes4,
                          device="cuda") -> TraceTables:
    """SAH SceneBvh + sorted normals/materials + raw (q, 32) BVH4 records
    (rtrt_tpu.bvh.sah.bvh4_nodes, before pack_nodes4) -> TraceTables."""
    return pack_tables(bvh_from_jax(bvh, device), _t(tri_nrm_t, device),
                       _t(sorted_mat, device, torch.int32),
                       _t(nodes4, device, torch.float32))


def sah2_tables_from_jax(bvh, tri_nrm_t, sorted_mat,
                         device="cuda") -> TraceTables:
    """The flat binary SAH SceneBvh of rtrt_tpu.bvh.sah.build_scene_tables_
    sah(..., leaf_max=8) + its sorted normals / materials (the JAX frame's
    prebuilt tables with nodes4=None) -> the port's binary leaf-row
    TraceTables."""
    return pack_tables_sah2(bvh_from_jax(bvh, device),
                            _t(tri_nrm_t, device),
                            _t(sorted_mat, device, torch.int32))


def ftex_from_jax(ftex) -> FourierTextures:
    """A JAX FourierTextures fit (rtrt_tpu.render.ftex) -> the port's: the
    same nested float tuples (host values; K2's wrapper puts the packed
    table on the device)."""
    def one(t):
        return FourierTexture(
            freq=tuple((float(fx), float(fy)) for fx, fy in t.freq),
            phase=tuple(float(p) for p in t.phase),
            weight=tuple(tuple(float(w) for w in ws) for ws in t.weight),
            mean=tuple(float(m) for m in t.mean))

    return FourierTextures(one(ftex.albedo_ao), one(ftex.normal_rough))


def sky_from_jax(sky, device="cuda") -> SkyMaps:
    p = sky.params
    params = SkyParams(*(_t(getattr(p, f), device, torch.float32) for f in (
        "sun_dir", "sun_intensity", "rayleigh_scale", "mie_scale", "mie_g",
        "altitude", "ground_albedo")))
    env_fit = None if sky.env_fit is None else _t(sky.env_fit, device)
    tables = {f: _t(getattr(sky, f), device) for f in (
        "sky_cdf", "sky_flux", "sun_cdf", "sun_flux", "sky_pdf", "sun_pdf",
        "sky_alias_p", "sky_alias_j", "sun_alias_p", "sun_alias_j")}
    return SkyMaps(sky_map=_t(sky.sky_map, device),
                   sun_map=_t(sky.sun_map, device),
                   sun_dir=_t(sky.sun_dir, device),
                   sun_basis_t=_t(sky.sun_basis_t, device),
                   sun_basis_b=_t(sky.sun_basis_b, device), params=params,
                   sun_trans=_t(sky.sun_trans, device), env_fit=env_fit,
                   **tables)


def materials_from_jax(m, device="cuda") -> Materials:
    return Materials(
        mtype=_t(m.mtype, device, torch.int32),
        albedo=_t(m.albedo, device, torch.float32),
        emission=_t(m.emission, device, torch.float32),
        roughness=_t(m.roughness, device, torch.float32),
        ior=_t(m.ior, device, torch.float32),
        f0=_t(m.f0, device, torch.float32),
        textured=_t(m.textured, device, torch.int32))


def lights_from_jax(lights, device="cuda"):
    if lights is None:
        return None
    return SphereLights(center=_t(lights.center, device, torch.float32),
                        radius=_t(lights.radius, device, torch.float32),
                        emission=_t(lights.emission, device, torch.float32))


def camera_from_jax(c, device="cuda") -> Camera:
    return Camera(*(_t(getattr(c, f), device, torch.float32) for f in (
        "pos", "yaw", "pitch", "fov_y", "aperture", "focal_dist")))


def exposure_from_jax(e, device="cuda") -> torch.Tensor:
    return _t(e, device, torch.float32)
