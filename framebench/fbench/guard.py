"""The check that nothing the benchmark ran loaded JAX or the JAX package:
the top-level name of every loaded module (the part before the first dot)
compared whole, so that `rtrt_tpu` does not match `rtrt_tpu_torch`."""

from __future__ import annotations

import sys

BANNED = ("jax", "jaxlib", "flax", "rtrt_tpu")


def banned_modules(modules=None) -> list:
    """The banned top-level names among `modules` (default: sys.modules)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(BANNED))
