"""rtrt_tpu_torch — the PyTorch + CUDA (Hopper) port of the rtrt_tpu path tracer.

The package mirrors `rtrt_tpu/`'s layout: each module's JAX counterpart sits
at the same relative path (``rtrt_tpu_torch.render.megakernel`` is held
against ``rtrt_tpu.render.megakernel``).  It imports torch and never jax,
and nothing of the JAX package: the host content pipeline
(``content/``) is its own copy, with the native C++ twin built from
``content/native/rtrt_native.cpp`` at first use.

It renders the static-scene product frame with the JAX Engine's default
settings (engine/engine.py: resolution buckets and the dynamic-resolution
controller, camera input and persistence; app/headless.py is the CLI) and
the default ``FeatureFlags()``:

  SAH/BVH4 tables (bvh/sah.py) -> raygen (render/raygen.py) ->
  path-trace megakernel (render/megakernel.py, CUDA K2 with the K1
  traversal of bvh/packet.py inside) -> G-buffer finish ->
  SVGF denoiser (denoise/pipeline.py: history reprojection, CUDA K5 in
  denoise/reproject.py; temporal filter; 7x7 and a-trous 5x5 passes,
  CUDA K4 in denoise/spatial.py; bf16 history) ->
  post chain (post/pipeline.py: exposure, bloom, lens flare, the fused
  tail kernel CUDA K3 of post/tail.py; below the screen size the
  Catmull-Rom upscale of ops/resize.py and K3's pre-mapped
  instantiation) -> uint8.

Hand-written kernels live in ``csrc/`` and are built with nvcc at first use
(utils/cuda.py).  Every kernel wrapper runs its plain PyTorch version for
CPU tensors and launches the kernel (or raises) for CUDA tensors.  Entry
points run on the card unless the caller passes ``device="cpu"``.
"""

__version__ = "0.2.0"
