"""Port of rtrt_tpu/bvh (see the package docstring)."""
