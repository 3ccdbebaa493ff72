"""fbref: framebench's plain reference of one frame.

A frozen copy of the plain PyTorch path of rtrt_tpu_torch (each module
names the file it was copied from), with every kernel replaced by its plain
version and cut to what framebench's frames reach: the megakernel route at
the screen size over the SAH BVH4 or the two-level LBVH (rebuilt under the
travelling wave), the default denoiser and post chain, the physical sky.
Nothing here imports the port, JAX or the JAX package.
"""
