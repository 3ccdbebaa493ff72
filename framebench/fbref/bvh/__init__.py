# Frozen copy of rtrt_tpu_torch/bvh/__init__.py
# (framebench's plain reference).
"""Port of rtrt_tpu/bvh (see the package docstring)."""
