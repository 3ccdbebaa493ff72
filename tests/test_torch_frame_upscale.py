"""The whole frame with the render size below the screen size: the port's
render_frame vs the JAX render_frame at render 32x16, screen 48x24, on the
demo scene with the default FeatureFlags() (denoised, three frames of a
slow pan): tone map at render size, Catmull-Rom upscale, then sharpen,
dither and quantize at screen size (the port: K3's pre-mapped
instantiation, here its plain version).  The bound of
tests/test_torch_frame.py, whose harness renders both: mean |delta| <= 2
LSB and >= 95% of pixels within 4 LSB on every channel, every frame.
The harness also renders the port's wavefront routes, held here to the
port's megakernel frames within 1 LSB."""

import numpy as np

from rtrt_tpu.core.camera import make_camera
from rtrt_tpu.utils.config import FeatureFlags as JFlags
from rtrt_tpu_torch.utils.config import FeatureFlags as TFlags
from test_torch_frame import _render_both

SW, SH = 48, 24


def test_upscaled_frame_matches_jax():
    cams = [make_camera(pos=(0.05 * k, 3.0, -9.0), yaw=0.01 * k,
                        pitch=-0.15, fov_y=1.1) for k in range(4)]
    ref, got, gbuf, more = _render_both(JFlags(), TFlags(), cams,
                                        screen=(SW, SH))
    assert len(got) == 3 and gbuf.color.shape == (16, 32, 3)
    for r, g in zip(ref, got):
        assert r.shape == g.shape == (SH, SW, 3) and g.dtype == np.uint8
        d = np.abs(r.astype(np.int32) - g.astype(np.int32))
        assert d.mean() <= 2.0, d.mean()
        assert (d.max(-1) <= 4).mean() >= 0.95, (d.max(-1) <= 4).mean()
    # the wavefront routes' upscaled frames, within 1 LSB of the
    # megakernel's (tests/test_torch_frame.py holds them to JAX's)
    for route in ("packets", "loop"):
        for m, g in zip(got, more[route]):
            assert g.shape == (SH, SW, 3)
            assert (np.abs(m.astype(np.int32) - g.astype(np.int32))
                    <= 1).all(), route
