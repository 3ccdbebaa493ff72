# Frozen copy of rtrt_tpu_torch/ops/__init__.py
# (framebench's plain reference).
"""Port of rtrt_tpu/ops (see the package docstring)."""
