"""Debug utilities: NaN guards, bounds-checked gathers, array dumps (port of
rtrt_tpu/utils/debug.py).

`DEBUG` is RTRT_DEBUG=1 at import; `nan_guard` and `safe_gather` read it
when their `enabled` is None.  Off, `nan_guard` is the identity (it adds no
launch to a frame); on, it zeroes NaN / Inf and prints their count, which
reads the count to the host: a sync, only under the flag.
"""

from __future__ import annotations

import os

import numpy as np
import torch

DEBUG = os.environ.get("RTRT_DEBUG", "0") == "1"


def _enabled(enabled: bool | None) -> bool:
    return DEBUG if enabled is None else enabled


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def nan_guard(x, label: str = "", enabled: bool | None = None):
    """x with NaN / Inf replaced by zeros, and their count printed as
    `[nan_guard:<label>] bad values: <n>`, when enabled; else x itself."""
    if not _enabled(enabled):
        return x
    bad = ~torch.isfinite(x)
    print(f"[nan_guard:{label}] bad values: {int(bad.sum())}")
    return torch.where(bad, 0.0, x)


def safe_gather(table, idx, label: str = "", enabled: bool | None = None):
    """table[idx] with idx clamped to [0, len(table) - 1]; when enabled, the
    count of out-of-range indices is printed."""
    n = table.shape[0]
    if _enabled(enabled):
        oob = int(((idx < 0) | (idx >= n)).sum())
        print(f"[safe_gather:{label}] oob indices: {oob}")
    return table[torch.clamp(idx, 0, n - 1).to(torch.int64)]


def center_pixel_print(img, label: str = ""):
    """Print the centre pixel of an (H,W,C) image."""
    h, w = img.shape[0], img.shape[1]
    print(f"[center:{label}] {_np(img[h // 2, w // 2])}")


def dump_csv(path: str, array, fmt: str = "%.7g"):
    """Write an array (a tensor on any device, or numpy) as CSV: one row
    per leading index."""
    a = _np(array)
    a2 = a.reshape(a.shape[0], -1) if a.ndim > 1 else a.reshape(-1, 1)
    np.savetxt(path, a2, delimiter=",", fmt=fmt)


def dump_bvh_intermediates(dirpath: str, bvh):
    """CSV dumps of a SceneBvh (bvh/types.py): sorted triangle ids, the
    boxes and children tables one node a row, the root box."""
    os.makedirs(dirpath, exist_ok=True)
    dump_csv(os.path.join(dirpath, "sorted_tri_index.csv"),
             bvh.sorted_tri_index, fmt="%d")
    dump_csv(os.path.join(dirpath, "boxes_t.csv"), bvh.boxes_t.T)
    dump_csv(os.path.join(dirpath, "children_t.csv"), bvh.children_t.T,
             fmt="%d")
    dump_csv(os.path.join(dirpath, "root_aabb.csv"),
             torch.stack([bvh.root_lo, bvh.root_hi]))


def frame_dump(path: str, img):
    """Write an image as PPM (path ending .ppm) or PNG."""
    from .image import write_png, write_ppm
    (write_ppm if path.endswith(".ppm") else write_png)(path, _np(img))
