"""The published analytic daylight sky: the Perez five-parameter luminance
distribution with the turbidity fits of Preetham et al. 1999 ("A Practical
Analytic Model for Daylight"), in numpy float64 (the port's own copy of
rtrt_tpu/render/skyref.py: the same formulas and constants).

render/sky.py::preetham_radiance reads the chromaticity tables and the
coefficient polynomials from here; the tests hold it against `sky_rgb`.
numpy only: it is never run inside a frame.
"""

from __future__ import annotations

import numpy as np


def perez(theta, gamma, a, b, c, d, e):
    """Perez sky luminance distribution F(theta, gamma).

    theta: view zenith angle; gamma: angle between view and sun.
    F = (1 + A exp(B / cos(theta))) (1 + C exp(D gamma) + E cos^2(gamma))
    """
    cos_t = np.maximum(np.cos(theta), 1e-3)
    return ((1.0 + a * np.exp(b / cos_t))
            * (1.0 + c * np.exp(d * gamma) + e * np.cos(gamma) ** 2))


def preetham_coeffs_Y(turbidity: float):
    """Luminance-channel Perez coefficients as a function of turbidity T
    (Preetham et al. 1999, appendix A.2)."""
    t = float(turbidity)
    return (0.1787 * t - 1.4630,
            -0.3554 * t + 0.4275,
            -0.0227 * t + 5.3251,
            0.1206 * t - 2.5771,
            -0.0670 * t + 0.3703)


def zenith_luminance(turbidity: float, theta_s: float) -> float:
    """Zenith luminance Y_z in kcd/m^2 (Preetham A.2); theta_s = sun
    zenith angle."""
    t = float(turbidity)
    chi = (4.0 / 9.0 - t / 120.0) * (np.pi - 2.0 * theta_s)
    return (4.0453 * t - 4.9710) * np.tan(chi) - 0.2155 * t + 2.4192


# --- chromaticity channels (Preetham A.2): Perez coefficients and zenith
# chromaticities as polynomials in turbidity T and sun zenith angle ---

_PEREZ_X = ((-0.0193, -0.2592), (-0.0665, 0.0008), (-0.0004, 0.2125),
            (-0.0641, -0.8989), (-0.0033, 0.0452))
_PEREZ_Y = ((-0.0167, -0.2608), (-0.0950, 0.0092), (-0.0079, 0.2102),
            (-0.0441, -1.6537), (-0.0109, 0.0529))
_ZENITH_X = ((0.00166, -0.00375, 0.00209, 0.0),
             (-0.02903, 0.06377, -0.03202, 0.00394),
             (0.11693, -0.21196, 0.06052, 0.25886))
_ZENITH_Y = ((0.00275, -0.00610, 0.00317, 0.0),
             (-0.04214, 0.08970, -0.04153, 0.00516),
             (0.15346, -0.26756, 0.06670, 0.26688))


def perez_coeffs_chroma(turbidity: float, table):
    t = float(turbidity)
    return tuple(a * t + b for a, b in table)


def zenith_chroma(turbidity: float, theta_s: float, m) -> float:
    t = float(turbidity)
    th = np.array([theta_s ** 3, theta_s ** 2, theta_s, 1.0])
    tv = np.array([t * t, t, 1.0])
    return float(tv @ np.asarray(m) @ th)


def sky_xyY(view_dirs: np.ndarray, sun_dir: np.ndarray,
            turbidity: float = 2.5):
    """Full Preetham sky: (x, y, Y) per view direction (numpy reference).

    Y in kcd/m^2; below-horizon directions clamp to the horizon value."""
    v = np.asarray(view_dirs, np.float64)
    s = np.asarray(sun_dir, np.float64)
    s = s / np.linalg.norm(s)
    up = np.clip(v[..., 1], 1e-3, 1.0)  # horizon clamp
    theta = np.arccos(up)
    gamma = np.arccos(np.clip(v @ s, -1.0, 1.0))
    theta_s = np.arccos(np.clip(s[1], -1.0, 1.0))

    out = []
    for table, zen in ((None, None), (_PEREZ_X, _ZENITH_X),
                       (_PEREZ_Y, _ZENITH_Y)):
        if table is None:
            coef = preetham_coeffs_Y(turbidity)
            z = zenith_luminance(turbidity, theta_s)
        else:
            coef = perez_coeffs_chroma(turbidity, table)
            z = zenith_chroma(turbidity, theta_s, zen)
        f = perez(theta, gamma, *coef)
        f0 = perez(0.0, theta_s, *coef)
        out.append(z * f / max(f0, 1e-9))
    yy, x, y = out
    return x, y, np.maximum(yy, 0.0)


def sky_rgb(view_dirs: np.ndarray, sun_dir: np.ndarray,
            turbidity: float = 2.5) -> np.ndarray:
    """Linear-sRGB Preetham sky (relative scale: Y in kcd/m^2)."""
    x, y, yy = sky_xyY(view_dirs, sun_dir, turbidity)
    y_safe = np.maximum(y, 1e-6)
    big_x = x / y_safe * yy
    big_z = (1.0 - x - y) / y_safe * yy
    xyz = np.stack([big_x, yy, big_z], axis=-1)
    m = np.array([[3.2406, -1.5372, -0.4986],
                  [-0.9689, 1.8758, 0.0415],
                  [0.0557, -0.2040, 1.0570]])
    return np.maximum(xyz @ m.T, 0.0)


def sky_luminance(view_dirs: np.ndarray, sun_dir: np.ndarray,
                  turbidity: float = 2.5) -> np.ndarray:
    """Relative sky luminance for (...,3) unit view directions (y up).

    Returns Y(view) normalized so the zenith value equals the Preetham
    zenith luminance; below-horizon directions return 0.  Absolute scale
    is irrelevant for distribution comparison — callers normalize.
    """
    v = np.asarray(view_dirs, np.float64)
    s = np.asarray(sun_dir, np.float64)
    s = s / np.linalg.norm(s)
    up = v[..., 1]
    theta = np.arccos(np.clip(up, -1.0, 1.0))
    cos_g = np.clip(v @ s, -1.0, 1.0)
    gamma = np.arccos(cos_g)
    theta_s = np.arccos(np.clip(s[1], -1.0, 1.0))
    coef = preetham_coeffs_Y(turbidity)
    f = perez(theta, gamma, *coef)
    f0 = perez(0.0, theta_s, *coef)  # zenith view
    yz = zenith_luminance(turbidity, theta_s)
    out = yz * f / max(f0, 1e-9)
    return np.where(up > 0.0, np.maximum(out, 0.0), 0.0)
