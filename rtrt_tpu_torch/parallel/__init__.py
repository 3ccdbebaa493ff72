"""The multi-device frame (port of rtrt_tpu/parallel/): the product frame
split into row bands over torch.distributed, one process per device
(`frame_spmd`), and the explicit-collectives teaching frame (`tile`).
Importing the package starts no process group."""
