"""Measure once the constants of K2's roofline count for a configuration and
traffic: node and leaf visits, shaded, textured and sampled hits, each a
mean per pixel over all segments, and the tables' bytes.

    python3 framebench/tools/k2_counts.py <config> <traffic> [--views 5]
        [--stride 4]

framebench's frozen plain traversal (fbref's megakernel_trace_plain) runs
on a fixed pixel subsample (every `stride`-th pixel of every `stride`-th
row) of the cell's resolution, at `views` yaws evenly over the pan's
swing, frame index 0, on the tree the program traces: the host-built SAH
BVH4 for bvh="sah4", the two-level LBVH for bvh="lbvh" (at rest).  It
prints the `k2_counts` object that the configuration's file keeps, with
the card it ran on.  The counts are the yardstick's, read from no
program: a later change to the port cannot move them.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def tables_for(config, mesh, dev):
    import torch
    from fbench.scene import padded
    from fbref.bvh.packet import pack_tables, pack_tables_binary
    from fbref.bvh.sah import build_scene_tables_sah, bvh4_nodes
    from fbref.engine.frame import build_scene_tables

    vertices, indices, normals = mesh
    idx, tri_mat, valid = padded(indices)
    if config["bvh"] == "sah4":
        bvh, nrm_t, mat = build_scene_tables_sah(
            valid.shape[0], idx, tri_mat, valid, vertices, normals,
            leaf_max=8)
        return pack_tables(bvh, nrm_t, mat, bvh4_nodes(bvh)).to(dev), "bvh4"
    t = lambda a, d=None: torch.from_numpy(a).to(dev, d)
    return pack_tables_binary(*build_scene_tables(
        valid.shape[0], t(idx, torch.int64), t(tri_mat, torch.int32),
        t(valid), t(vertices), t(normals))), "binary"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("config")
    ap.add_argument("traffic")
    ap.add_argument("--views", type=int, default=5)
    ap.add_argument("--stride", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from fbench.reference import Reference
    from fbench.scene import make_mesh
    from fbref.core.camera import camera_basis
    from fbref.render.kshade import pack_materials_rows
    from fbref.render.megakernel import (megakernel_trace_plain,
                                         pack_sun_params)
    from fbref.render.raygen import generate_rays_padded
    from fbref.render.sampling import rand2_bn

    with open(os.path.join(HERE, "configs", args.config + ".json")) as f:
        config = json.load(f)
    with open(os.path.join(HERE, "traffic", args.traffic + ".json")) as f:
        traffic = json.load(f)
    dev = torch.device(args.device)
    mesh = make_mesh(config["terrain"])
    ref = Reference(dict(config, animation="none"), traffic, mesh, dev)
    tables, tree = tables_for(config, mesh, dev)
    s = args.stride
    ids = ref.consts.pixel_ids[::s, ::s].contiguous()
    bn = ref.consts.bn[::s, ::s].contiguous()
    w, h = ref.static.render_w, ref.static.render_h
    swing = traffic["pan"]["amplitude_px"] * traffic["pan"]["look_speed"]
    visits, hits = [0, 0], [0, 0, 0]
    cam = config["camera"]
    for yaw in np.linspace(-swing, swing, args.views):
        basis = camera_basis(ref.camera(
            [*cam["pos"], yaw, cam["pitch"], cam["fov_y"], cam["aperture"],
             cam["focal_dist"]]))
        rays = generate_rays_padded(basis, w, h, ids, rand2_bn(bn, 0, 0),
                                    rand2_bn(bn, 0, 256))
        megakernel_trace_plain(
            tables, pack_materials_rows(ref.scene.materials).to(dev),
            pack_sun_params(ref.scene.sky), 0, rays.org.contiguous(),
            rays.dir.contiguous(), rays.cone_width.contiguous(), ids, bn=bn,
            visits=visits, hits=hits)
    n = ids.numel() * args.views
    table_bytes = sum(getattr(tables, f).numel() * 4
                      for f in ("nodes", "tris", "nrm", "ng", "mat"))
    card = torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"
    counts = dict(tree=tree, node_visits=visits[0] / n,
                  leaf_visits=visits[1] / n, shaded_hits=hits[0] / n,
                  textured_hits=hits[1] / n, sampled_hits=hits[2] / n,
                  table_bytes=table_bytes,
                  source=f"framebench/tools/k2_counts.py {args.config} "
                         f"{args.traffic} --views {args.views} --stride "
                         f"{s}: {n} paths, frame 0, on {card}")
    print(json.dumps(counts))
    return counts


if __name__ == "__main__":
    main()
