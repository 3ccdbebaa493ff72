"""Port of rtrt_tpu/render (see the package docstring)."""
