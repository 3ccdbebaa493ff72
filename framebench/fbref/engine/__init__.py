# Frozen copy of rtrt_tpu_torch/engine/__init__.py
# (framebench's plain reference).
"""Port of rtrt_tpu/engine (see the package docstring)."""
