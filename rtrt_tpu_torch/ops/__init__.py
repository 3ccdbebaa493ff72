"""Port of rtrt_tpu/ops (see the package docstring)."""
