"""The camera path of a traffic mix: a slow yaw pan driven through the
Engine's cursor input, one cursor event a frame, as the viewer sends them.

The pan is a triangle wave of the cursor's x position: `px_per_frame`
pixels a frame, turning at +-`amplitude_px`, so one period is
4 * amplitude_px / px_per_frame frames.  The seed picks the phase (where in
the period the run starts) and the first frame index; every seed runs the
same path, only entered at another point.

`CameraMirror` replays the same events with the Engine's float32 camera
arithmetic (a frozen copy of rtrt_tpu_torch/engine/engine.py::cursor_event,
yaw += float32(dx * look_speed)), so that the reference works the camera of
every frame out again from the input alone.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Pan:
    amplitude_px: int      # turning points of the cursor's x, +-pixels
    px_per_frame: int      # cursor pixels a frame
    phase: int             # the first frame's step in the period
    y_px: int = 0          # the cursor's fixed y

    @property
    def period(self) -> int:
        return 4 * self.amplitude_px // self.px_per_frame

    def x(self, k: int) -> int:
        """The cursor's x (pixels) at the k-th event of the run."""
        n = (self.phase + k) % self.period
        quarter = self.period // 4
        if n < quarter:
            steps = n
        elif n < 3 * quarter:
            steps = 2 * quarter - n
        else:
            steps = n - self.period
        return steps * self.px_per_frame


def make_pan(traffic: dict, rng: np.random.Generator) -> Pan:
    p = traffic["pan"]
    pan = Pan(amplitude_px=int(p["amplitude_px"]),
              px_per_frame=int(p["px_per_frame"]), phase=0)
    return dataclasses.replace(pan, phase=int(rng.integers(0, pan.period)))


class CameraMirror:
    """The camera's float32 values [pos x, y, z, yaw, pitch, fov_y,
    aperture, focal_dist] after each cursor event, computed as the Engine
    computes them; `prev` holds the values of the frame before."""

    def __init__(self, start: np.ndarray, look_speed: float):
        self.values = np.asarray(start, np.float32).copy()
        self.prev = self.values.copy()
        self.look_speed = look_speed
        self.last = None

    def cursor(self, x: float, y: float):
        last, self.last = self.last, (x, y)
        if last is None:
            return
        dx, dy = x - last[0], y - last[1]
        v = self.values.copy()
        v[3] = v[3] + np.float32(dx * self.look_speed)
        v[4] = np.clip(v[4] - np.float32(dy * self.look_speed), -1.5, 1.5)
        self.values = v.astype(np.float32)

    def end_frame(self):
        """After a frame: its camera is the next frame's previous one."""
        self.prev = self.values.copy()
