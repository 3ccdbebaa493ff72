# Frozen copy of rtrt_tpu_torch/denoise/__init__.py
# (framebench's plain reference).
