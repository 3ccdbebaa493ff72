"""Port of rtrt_tpu/core (see the package docstring)."""
