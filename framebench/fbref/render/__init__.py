# Frozen copy of rtrt_tpu_torch/render/__init__.py
# (framebench's plain reference).
"""Port of rtrt_tpu/render (see the package docstring)."""
