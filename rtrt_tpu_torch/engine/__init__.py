"""Port of rtrt_tpu/engine (see the package docstring)."""
