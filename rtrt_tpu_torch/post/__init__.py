"""Port of rtrt_tpu/post (see the package docstring)."""
