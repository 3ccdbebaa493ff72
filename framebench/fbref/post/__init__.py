# Frozen copy of rtrt_tpu_torch/post/__init__.py
# (framebench's plain reference).
"""Port of rtrt_tpu/post (see the package docstring)."""
