"""rtrt_tpu_torch — the PyTorch + CUDA (Hopper) port of the rtrt_tpu path tracer.

The package mirrors `rtrt_tpu/`'s layout: each module's JAX counterpart sits
at the same relative path (``rtrt_tpu_torch.render.megakernel`` is held
against ``rtrt_tpu.render.megakernel``).  It imports torch and never jax.

This slice renders the static-scene product frame with
``FeatureFlags(denoise=False, bloom=False, lens_flare=False)``:

  SAH/BVH4 tables (bvh/sah.py) -> raygen (render/raygen.py) ->
  path-trace megakernel (render/megakernel.py, CUDA K2 with the K1
  traversal of bvh/packet.py inside) -> G-buffer finish ->
  post chain (post/pipeline.py) with the fused tail kernel (post/tail.py,
  CUDA K3) -> uint8.

Hand-written kernels live in ``csrc/`` and are built with nvcc at first use
(utils/cuda.py).  Every kernel wrapper runs its plain PyTorch version for
CPU tensors and launches the kernel (or raises) for CUDA tensors.
"""

__version__ = "0.1.0"
