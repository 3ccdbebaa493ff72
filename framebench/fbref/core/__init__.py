# Frozen copy of rtrt_tpu_torch/core/__init__.py
# (framebench's plain reference).
"""Port of rtrt_tpu/core (see the package docstring)."""
