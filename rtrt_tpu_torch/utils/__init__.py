"""Port of rtrt_tpu/utils (see the package docstring)."""
