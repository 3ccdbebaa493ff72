"""Rank bodies of the row-sharded tests (tests/test_torch_parallel.py,
tests/test_torch_frame.py, tests/test_torch_kernels_gpu.py), run by
rtrt_tpu_torch/parallel/frame_spmd.py::spawn in processes of their own.
JAX-free, so that a rank imports only the port.  Each takes its inputs
from a torch.save file and writes its results to one (rank 0's, unless it
says otherwise)."""

import torch

from rtrt_tpu_torch.bvh.packet import overflow_counter
from rtrt_tpu_torch.parallel import frame_spmd as S
from rtrt_tpu_torch.parallel import tile as T


def _load(path):
    return torch.load(path, weights_only=False)


def collectives(rank, inp, out):
    """4 ranks on the CPU: band_rows at halos of 1 row, a whole band and
    more than a band, _halo_exchange, _global_histogram, sharded_refit and
    the mesh's refusals.  Every rank writes its record to out + rank."""
    d = _load(inp)
    mesh = S.make_row_mesh(d["img"].shape[0], device="cpu")
    band = d["img"][mesh.r0:mesh.r1]
    rows = mesh.r1 - mesh.r0
    rec = dict(rows=(mesh.r0, mesh.r1))
    rec["band_rows"] = {k: S.band_rows(mesh, band, mesh.r0 - k, mesh.r1 + k)
                        for k in (1, rows, rows + 3)}
    rec["halo"] = {k: T._halo_exchange(band, k, mesh) for k in (2, rows + 1)}
    hs = d["halo_img"].shape[0] // mesh.world
    rec["jax_halo"] = T._halo_exchange(
        d["halo_img"][mesh.rank * hs:(mesh.rank + 1) * hs], 2, mesh)
    rec["hist"] = [T._global_histogram(
        lum[mesh.rank * (lum.shape[0] // mesh.world):
            (mesh.rank + 1) * (lum.shape[0] // mesh.world)], mesh)
        for lum in d["lums"]]
    rec["refit"] = S.sharded_refit(mesh, d["plan"], d["tris_t"],
                                   d["n_leaves"])
    refused = {}
    for name, fn in (
            ("make_row_mesh", lambda: S.make_row_mesh(18, device="cpu")),
            ("screen_h", lambda: S.make_row_mesh(16, 30, device="cpu")),
            ("spmd_height", lambda: S.make_spmd_frame_fn(
                mesh, d["static_h"])),
            ("spmd_packets", lambda: S.make_spmd_frame_fn(
                S.make_row_mesh(16, device="cpu"), d["static_packets"])),
            ("refit_pad", lambda: S.sharded_refit(
                mesh, d["plan"], d["tris_t"], d["n_leaves"] - 1))):
        try:
            fn()
        except ValueError as e:
            refused[name] = str(e)
    rec["refused"] = refused
    torch.save(rec, f"{out}{rank}")


def sharded_frames(rank, inp, out):
    """The row-sharded frame of each run in the input (static, scene,
    state, cameras, params, frames): frame k from cameras[k + 1] with
    cameras[k] as the previous camera.  Rank 0 writes each run's gathered
    images, and every rank its history shape and dropped pushes."""
    runs = _load(inp)
    res = {}
    for name, r in runs.items():
        static, scene = r["static"], r["scene"]
        dev = scene.tables.nodes.device
        mesh = S.make_row_mesh(static.render_h, static.screen_h, device=dev)
        S.replicate(mesh, scene)
        fn = S.make_spmd_frame_fn(mesh, static)
        state = S.shard_frame_state(mesh, r["state"])
        ovf = overflow_counter(dev)
        imgs = []
        cams = r["cams"][:r["frames"] + 1]
        for prev, cam in zip(cams, cams[1:]):
            img, state, _ = fn(scene, state, cam, prev, r["params"], 1 / 60,
                               overflow=ovf)
            full = S.gather_image(mesh, img)
            if full is not None:
                imgs.append(full.cpu())
        res[name] = dict(images=imgs, overflow=int(ovf),
                         history=None if state.history is None
                         else tuple(state.history.color.shape))
    torch.save(res, f"{out}{rank}")


def tile_frames(rank, inp, out):
    """The teaching frame (parallel/tile.py) over the input's frames; rank
    0 writes the gathered images."""
    d = _load(inp)
    mesh = S.make_row_mesh(d["height"], device="cpu")
    fn = T.make_tile_frame(mesh, lambda v: d["scene"], d["width"],
                           d["height"], d["denoise"])
    hist = d["hist"][mesh.r0:mesh.r1]
    imgs = []
    for k, (prev, cam) in enumerate(zip(d["cams"], d["cams"][1:])):
        img, hist = fn(None, cam, prev, hist, k)
        full = S.gather_image(mesh, img)
        if full is not None:
            imgs.append(full)
    if rank == 0:
        torch.save(imgs, out)
