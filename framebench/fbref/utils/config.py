# Frozen copy of rtrt_tpu_torch/utils/config.py
# (framebench's plain reference).
"""Configuration: TOML launch settings, feature flags and runtime
parameters.

Port of rtrt_tpu/utils/config.py.  Field names and defaults are identical
(tests/test_torch_config.py pins them against the JAX dataclasses).  The
runtime-tunable parameter groups are plain dataclasses of Python floats
instead of NamedTuple pytrees of traced scalars: the port runs eagerly, so
a parameter change never recompiles anything.  `get_param` / `set_param`
address them by dotted path ("post.bloom_strength"), as the JAX ones do,
and `PARAM_REGISTRY` lists the runtime-tunable ones for a generic
parameter panel (app/viewer.py), entry for entry the JAX registry.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DynamicResolution:
    enabled: bool = True
    target_fps: float = 60.0
    deadband_fps: float = 2.0
    min_width: int = 640
    max_width: int = 3840


@dataclasses.dataclass(frozen=True)
class GlobalSettings:
    render_width: int = 1920
    render_height: int = 1080
    window_width: int = 2560
    window_height: int = 1440
    scene: str = "terrain"          # terrain | mesh:<path> | demo
    mesh_path: str = ""
    camera_path: str = "camera.json"
    load_camera_at_init: bool = False
    texture_size: int = 512
    terrain_chunks: int = 4
    terrain_seed: int = 7
    terrain_style: str = "smooth"    # smooth | roundcube
    sky_model: str = "physical"      # physical | preetham
    interlace: bool = False
    frame_cap_fps: float = 75.0
    dynamic_resolution: DynamicResolution = dataclasses.field(
        default_factory=DynamicResolution)


@dataclasses.dataclass(frozen=True)
class FeatureFlags:
    """Structural render-pass toggles (same fields as the JAX FeatureFlags)."""

    denoise: bool = True
    temporal_filter: bool = True
    spatial_filter: bool = True
    second_temporal: bool = True
    postprocess: bool = True
    bloom: bool = True
    lens_flare: bool = True
    auto_exposure: bool = True
    sharpen: bool = True
    dither: bool = True
    textures: bool = True
    procedural_textures: bool = True
    fourier_textures: bool = False
    rebuild_bvh_every_frame: bool = True
    blue_noise: bool = True
    half_history: bool = True
    ocean: bool = False
    stars: bool = False


@dataclasses.dataclass
class SampleParams:
    aperture: float
    focal_dist: float


@dataclasses.dataclass
class DenoiseParams:
    sigma_normal: float
    sigma_depth: float
    sigma_material: float
    temporal_blend: float
    anti_flicker: float
    noise_threshold: float
    noise_threshold_16: float


@dataclasses.dataclass
class PostParams:
    exposure_gain: float
    manual_exposure: float
    bloom_strength: float
    flare_strength: float
    tone_map: float        # 0 reinhard, 1 aces_fitted, 2 aces, 3 uncharted2
    sharpen_amount: float
    gamma: float


@dataclasses.dataclass
class SkyTuning:
    time_of_day: float
    sun_axis_angle: float
    sun_intensity: float
    rayleigh: float
    mie: float
    mie_g: float


@dataclasses.dataclass
class RenderParams:
    sample: SampleParams
    denoise: DenoiseParams
    post: PostParams
    sky: SkyTuning


def default_params() -> RenderParams:
    return RenderParams(
        sample=SampleParams(aperture=0.0, focal_dist=10.0),
        denoise=DenoiseParams(
            sigma_normal=64.0, sigma_depth=0.1, sigma_material=1.0,
            temporal_blend=0.12, anti_flicker=1.0,
            noise_threshold=0.001, noise_threshold_16=0.001),
        post=PostParams(exposure_gain=1.0, manual_exposure=1.0,
                        bloom_strength=0.05, flare_strength=1.0,
                        tone_map=1.0, sharpen_amount=0.5, gamma=2.2),
        sky=SkyTuning(time_of_day=0.35, sun_axis_angle=0.3,
                      sun_intensity=20.0, rayleigh=1.0, mie=1.0,
                      mie_g=0.76),
    )
