"""Frame timing: delta time, FPS counter, frame limiter, scope timer, the
once-a-second FPS line (port of rtrt_tpu/utils/timer.py).

Host clocks only.  The port's frame returns before the card has finished
it (Engine.render_frame_device does not synchronise), so `Timer.update()`
between frames reads the host's enqueue interval until the launch queue
fills, and the card's frame interval after that.
"""

from __future__ import annotations

import time


class Timer:
    def __init__(self):
        self._last = time.perf_counter()
        self.delta = 0.0
        self._fps_acc = 0.0
        self._fps_n = 0
        self.fps = 0.0

    def update(self) -> float:
        now = time.perf_counter()
        self.delta = now - self._last
        self._last = now
        self._fps_acc += self.delta
        self._fps_n += 1
        if self._fps_acc >= 1.0:
            self.fps = self._fps_n / self._fps_acc
            self._fps_acc = 0.0
            self._fps_n = 0
        return self.delta

    def update_with_limiter(self, min_frame_time: float) -> float:
        """Busy-wait so the frame takes at least `min_frame_time` seconds."""
        target = self._last + min_frame_time
        while time.perf_counter() < target:
            pass
        return self.update()


class ScopeTimer:
    def __init__(self, label: str, quiet: bool = False):
        self.label = label
        self.quiet = quiet
        self.elapsed = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        if not self.quiet:
            print(f"[timer] {self.label}: {self.elapsed * 1e3:.2f} ms")
        return False


class FpsLog:
    """Once-per-second FPS + resolution + graph counts log line."""

    def __init__(self, interval: float = 1.0):
        self.interval = interval
        self._last = time.perf_counter()

    def maybe_log(self, fps: float, width: int, height: int,
                  graph_counts: dict):
        """graph_counts: the Engine's (frames replayed, graphs captured,
        frames run eagerly by reason), printed after the resolution."""
        # fps == 0.0: the Timer has not accumulated a second of frames yet
        if fps <= 0.0:
            return
        now = time.perf_counter()
        if now - self._last >= self.interval:
            self._last = now
            print(f"[fps] {fps:6.1f} @ {width}x{height} graphs {graph_counts}")
