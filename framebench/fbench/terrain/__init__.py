"""Frozen copies of the port's host content pipeline (rtrt_tpu_torch/
content/{perlin,terrain,marching}.py), numpy only: the terrain mesh that
framebench hands to the program and to its reference."""
