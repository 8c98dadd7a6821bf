"""Timer resource (mo_ecs/src/resource/timer.rs).

Frame clock: per-frame delta, total time, FPS over a 1-second window
(timer.rs:32-77) and the ``update_timer`` system (timer.rs:80-82).
"""

from __future__ import annotations

import time


class Timer:
    def __init__(self):
        now = time.perf_counter()
        self._start = now
        self._last = now
        self._delta = 0.0
        self._fps_window_start = now
        self._fps_frames = 0
        self._fps = 0.0
        # When set, the clock advances by a fixed step per frame instead of
        # wall time — used for deterministic camera paths and tests.
        self.fixed_step: float | None = None

    def next(self) -> None:
        """Advance the clock one frame (timer.rs:32-53)."""
        if self.fixed_step is not None:
            self._delta = self.fixed_step
            self._last += self.fixed_step
            self._fps_frames += 1
            return
        now = time.perf_counter()
        self._delta = now - self._last
        self._last = now
        self._fps_frames += 1
        window = now - self._fps_window_start
        if window >= 1.0:
            self._fps = self._fps_frames / window
            self._fps_frames = 0
            self._fps_window_start = now

    def fps(self) -> float:
        return self._fps

    def delta(self) -> float:
        """Seconds since previous frame (timer.rs:70-77)."""
        return self._delta

    def total(self) -> float:
        return self._last - self._start

    @staticmethod
    def update_timer(world) -> None:
        """ECS system (timer.rs:80-82)."""
        world.resource(Timer).next()
