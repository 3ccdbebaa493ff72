"""Host-side content generation (numpy, and the native C++ twin built
from native/rtrt_native.cpp): copies of the JAX package's rtrt_tpu/content
modules that the port's scene and SAH code use."""
