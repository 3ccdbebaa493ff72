# Frozen copy of rtrt_tpu_torch/content/perlin.py (framebench's terrain
# generator).
"""Classic improved Perlin noise (2D/3D), seedable, vectorized numpy.

Counterpart of the reference's Perlin implementation
(reference: src/perlin.h:9-127).  Standard Ken Perlin 2002 algorithm:
hashed gradient grid + quintic fade; the permutation table is generated
from a seeded shuffle rather than the canonical table.

Host-side (content generation runs at init time); a C++ twin lives in
native/ for the native content pipeline.  Copy of
rtrt_tpu/content/perlin.py: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np


class Perlin:
    def __init__(self, seed: int = 0):
        rng = np.random.default_rng(seed)
        p = rng.permutation(256)
        self.perm = np.concatenate([p, p]).astype(np.int32)

    @staticmethod
    def _fade(t):
        return t * t * t * (t * (t * 6 - 15) + 10)

    def _grad3(self, h, x, y, z):
        """12-direction gradient dot product."""
        h = h & 15
        u = np.where(h < 8, x, y)
        v = np.where(h < 4, y, np.where((h == 12) | (h == 14), x, z))
        return np.where(h & 1, -u, u) + np.where(h & 2, -v, v)

    def noise3(self, x, y, z):
        """3D noise in [-1, 1]; inputs broadcastable float arrays."""
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        z = np.asarray(z, np.float64)
        xi = np.floor(x).astype(np.int64) & 255
        yi = np.floor(y).astype(np.int64) & 255
        zi = np.floor(z).astype(np.int64) & 255
        xf = x - np.floor(x)
        yf = y - np.floor(y)
        zf = z - np.floor(z)
        u, v, w = self._fade(xf), self._fade(yf), self._fade(zf)
        p = self.perm

        def h(a, b, c):
            return p[p[p[a] + b] + c]

        def lerp(a, b, t):
            return a + t * (b - a)

        n000 = self._grad3(h(xi, yi, zi), xf, yf, zf)
        n100 = self._grad3(h(xi + 1, yi, zi), xf - 1, yf, zf)
        n010 = self._grad3(h(xi, yi + 1, zi), xf, yf - 1, zf)
        n110 = self._grad3(h(xi + 1, yi + 1, zi), xf - 1, yf - 1, zf)
        n001 = self._grad3(h(xi, yi, zi + 1), xf, yf, zf - 1)
        n101 = self._grad3(h(xi + 1, yi, zi + 1), xf - 1, yf, zf - 1)
        n011 = self._grad3(h(xi, yi + 1, zi + 1), xf, yf - 1, zf - 1)
        n111 = self._grad3(h(xi + 1, yi + 1, zi + 1), xf - 1, yf - 1, zf - 1)
        x00 = lerp(n000, n100, u)
        x10 = lerp(n010, n110, u)
        x01 = lerp(n001, n101, u)
        x11 = lerp(n011, n111, u)
        y0 = lerp(x00, x10, v)
        y1 = lerp(x01, x11, v)
        return lerp(y0, y1, w).astype(np.float32)

    def noise2(self, x, y):
        return self.noise3(x, y, np.zeros_like(np.asarray(x, np.float64)))

    def fbm3(self, x, y, z, octaves=4, lacunarity=2.0, gain=0.5):
        """Fractal Brownian motion stack of noise3."""
        total = np.zeros(np.broadcast(np.asarray(x), np.asarray(y),
                                      np.asarray(z)).shape, np.float32)
        amp = 1.0
        freq = 1.0
        norm = 0.0
        for _ in range(octaves):
            total += amp * self.noise3(x * freq, y * freq, z * freq)
            norm += amp
            amp *= gain
            freq *= lacunarity
        return total / norm
