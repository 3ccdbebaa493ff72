"""framebench: the benchmark of rtrt_tpu_torch (see framebench/run.py)."""
