# Frozen copy of rtrt_tpu_torch/utils/__init__.py
# (framebench's plain reference).
"""Port of rtrt_tpu/utils (see the package docstring)."""
