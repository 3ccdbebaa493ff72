"""Floating-point error bounds of the watertight intersectors (port of
rtrt_tpu/core/precision.py).  The constants are IEEE-754 float32 facts, as
Python floats."""

from __future__ import annotations

import torch

MACHINE_EPSILON = 5.960464477539063e-08  # float32 unit roundoff, 2^-24


def err_gamma(n: float) -> float:
    """PBRT's gamma(n) = n eps / (1 - n eps): the relative error bound after
    n floating-point operations."""
    ne = n * MACHINE_EPSILON
    return ne / (1.0 - ne)


GAMMA3 = err_gamma(3.0)
GAMMA5 = err_gamma(5.0)
GAMMA7 = err_gamma(7.0)


def next_float_up(x):
    """The next float32 toward +inf (one ulp step on the bits)."""
    x = torch.as_tensor(x, dtype=torch.float32)
    bits = x.view(torch.int32)
    out = torch.where(x >= 0, bits + 1, bits - 1).view(torch.float32)
    return torch.where(x == 0.0, torch.full_like(x, 1e-45), out)


def next_float_down(x):
    """The next float32 toward -inf."""
    x = torch.as_tensor(x, dtype=torch.float32)
    bits = x.view(torch.int32)
    out = torch.where(x > 0, bits - 1, bits + 1).view(torch.float32)
    return torch.where(x == 0.0, torch.full_like(x, -1e-45), out)
