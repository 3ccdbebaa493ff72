# Frozen copy of rtrt_tpu_torch/ops/scan.py
# (framebench's plain reference).
"""Prefix sums and CDF construction (port of rtrt_tpu/ops/scan.py): the
sky and sun maps' luminance CDFs."""

from __future__ import annotations

import torch


def pdf_to_cdf(pdf):
    """Inclusive CDF over the last axis of a non-negative density,
    normalised so that its last entry is 1 (an all-zero row becomes
    uniform).  Returns (cdf, total): total is the row's unnormalised sum."""
    cdf = torch.cumsum(pdf, dim=-1)
    total = cdf[..., -1:]
    n = pdf.shape[-1]
    uniform = (torch.arange(1, n + 1, dtype=torch.float32,
                            device=pdf.device) / n).expand(cdf.shape)
    return torch.where(total > 0.0, cdf / torch.clamp(total, min=1e-30),
                       uniform), total[..., 0]
