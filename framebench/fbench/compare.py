"""The comparison that decides `correct`: the program's compared frame
against the plain reference's frame from the same inputs.

Each number is computed over the whole frame at the timed size, and each
has a limit of its own in the cell's file framebench/limits/<cell>.json
(set from the readings of sound runs and of the control, PERF.md §2).
`correct` holds when every number of the cell is at or under its limit.

A 1-spp path tracer diverges where one rounding flips a decision (a bounce
direction, a shadow-or-scatter choice): the kernels contract products into
FMAs that the plain version rounds apart.  So the numbers read shares and
percentiles over pixels, which a few diverged paths barely move, and which
a wrong plane, a stale state or a missing half of the rows moves by a
large share.
"""

from __future__ import annotations

import numpy as np
import torch

# per-pixel tolerances of the G-buffer's primary surface (chip_smoke.py's
# K2 check): depth rtol 1e-4, normal and albedo 5e-3 absolute
DEPTH_RTOL, VEC_ATOL = 1e-4, 5e-3
# floor of the relative error's denominator (radiance and history colour)
REL_FLOOR = 1e-3


def _quantile(x: torch.Tensor, q: float) -> float:
    flat = torch.sort(x.reshape(-1).float()).values
    return float(flat[min(flat.numel() - 1, int(q * flat.numel()))])


def _rel(a, b):
    """Per pixel: the largest channel's |a - b| / (|b| + REL_FLOOR)."""
    a, b = a.float(), b.float()
    r = (a - b).abs() / (b.abs() + REL_FLOOR)
    return r.amax(-1) if r.dim() == 3 else r


def readings(prog: dict, ref: dict, with_tris: bool) -> dict:
    """The numbers compared, by name:
      gbuf_surface_share  the share of pixels whose primary surface
                          disagrees (material, depth, normal or albedo
                          beyond the tolerances above);
      gbuf_color_p50      the median pixel's relative radiance error;
      gbuf_motion_p50     the median pixel's motion-vector error (uv);
      hist_p90            the 90th percentile pixel's relative error of the
                          new history's final accumulation (colour2);
      image_mean          the mean absolute difference of the u8 image,
                          in levels;
      tris_max            (with_tris) the largest gap between the traced
                          tables' triangles (canonical_tris)."""
    gp, gr = prog["gbuffer"], ref["gbuffer"]
    depth_ok = torch.isclose(gp["depth"], gr["depth"], rtol=DEPTH_RTOL,
                             atol=0.0) | (torch.isinf(gp["depth"])
                                          & torch.isinf(gr["depth"]))
    vec_ok = lambda k: (gp[k] - gr[k]).abs().amax(-1) <= VEC_ATOL
    surface = depth_ok & (gp["mat_id"] == gr["mat_id"]) & vec_ok("normal") \
        & vec_ok("albedo")
    diff = (prog["image"].int() - ref["image"].int()).abs()
    out = {
        "gbuf_surface_share": 1.0 - float(surface.float().mean()),
        "gbuf_color_p50": _quantile(_rel(gp["color"], gr["color"]), 0.50),
        "gbuf_motion_p50": _quantile(
            (gp["motion"] - gr["motion"]).abs().amax(-1), 0.50),
        "hist_p90": _quantile(_rel(prog["history"].color2,
                                   ref["history"].color2), 0.90),
        "image_mean": float(diff.float().mean()),
    }
    if with_tris:
        out["tris_max"] = tris_gap(prog["tris"], ref["tris"])
    return out


def chain_readings(prog, ref) -> dict:
    """The numbers of the chain: the program's (history, exposure) after the
    run's first frames against the reference's after the same frames, each
    from its own start state, so that what builds up over frames shows:
      chain_hist_p50, chain_hist_p90  the median and the 90th percentile
                          pixel's relative error of the history's final
                          accumulation (colour2);
      chain_count_share   the share of pixels whose accumulated sample
                          count differs;
      chain_exposure      the largest relative gap of the exposure state."""
    (hp, ep), (hr, er) = prog, ref
    rel = _rel(hp.color2, hr.color2)
    ep, er = ep.double().cpu(), er.double().cpu()
    return {
        "chain_hist_p50": _quantile(rel, 0.50),
        "chain_hist_p90": _quantile(rel, 0.90),
        "chain_count_share": float((hp.count.float() != hr.count.float())
                                   .float().mean()),
        "chain_exposure": float(((ep - er).abs() / (er.abs() + REL_FLOOR))
                                .max()),
    }


def canonical_tris(tris: torch.Tensor) -> torch.Tensor:
    """A tables' (P, 9) triangle records [v0 | v1 - v0 | v2 - v0] as
    vertex coordinates (P, 9), each of the 9 columns sorted on its own: a
    summary that does not depend on the tree's order of the triangles, and
    that moves by no more than the coordinates do."""
    t = tris.double()
    v = torch.cat([t[:, 0:3], t[:, 0:3] + t[:, 3:6], t[:, 0:3] + t[:, 6:9]],
                  1)
    return torch.sort(v, dim=0).values


def tris_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest gap between two tables' canonical triangle coordinates;
    inf where they hold different counts."""
    if a.shape != b.shape:
        return float("inf")
    return float((canonical_tris(a) - canonical_tris(b)).abs().max())


def start_gap(prog, ref) -> float:
    """The largest gap between the program's state before its first frame
    and the reference's initial state, each (history, exposure): the start
    that every later frame follows from.  Equal values (inf included) count
    0; a history whose valid flag differs counts 1; no history against a
    history counts inf."""
    (hp, ep), (hr, er) = prog, ref
    pairs = [(ep, er)]
    if (hp is None) != (hr is None):
        return float("inf")
    gap = 0.0
    if hp is not None:
        gap = float(hp.valid != hr.valid)
        pairs += [(getattr(hp, f), getattr(hr, f)) for f in hr._fields
                  if f != "valid"]
    for a, b in pairs:
        a, b = a.double().cpu(), b.double().cpu()
        if a.shape != b.shape:
            return float("inf")
        d = torch.where(a == b, 0.0, (a - b).abs())
        gap = max(gap, float(torch.nan_to_num(d, nan=float("inf")).max()))
    return gap


def judge(numbers: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}) over the cell's limits; a
    number without a limit, or a limit without a number, is not correct."""
    check = {k: {"value": numbers.get(k), "limit": v}
             for k, v in limits.items()}
    ok = all(c["value"] is not None and np.isfinite(c["value"])
             and c["value"] <= c["limit"] for c in check.values())
    return ok, check
