"""Constant tensors built once per value and device.

A frame that builds a small constant with `torch.tensor(...).to(device)`
copies it from the host every frame, and a frame captured as a CUDA graph
(engine/engine.py) cannot copy from pageable host memory at all.
`device_const` makes the copy once and hands back the same tensor after,
so the frame reads it where it lies.
"""

from __future__ import annotations

import torch

_CACHE: dict = {}


def device_const(values, device, dtype=torch.float32) -> torch.Tensor:
    """`torch.tensor(values, dtype=dtype)` on `device`, copied there at the
    first call for these values (without a stream sync) and returned again
    by every later one.  values: a number or a (nested) tuple of numbers.
    Never write to it."""
    dev = torch.device(device)
    key = (values, dev, dtype)
    t = _CACHE.get(key)
    if t is None:
        t = _CACHE[key] = torch.tensor(values, dtype=dtype).to(
            dev, non_blocking=True)
    return t
