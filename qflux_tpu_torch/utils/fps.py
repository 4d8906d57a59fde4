"""Throughput: warm-up discard, sliding window and EMA, pause / resume.

Counterpart of qflux_tpu/utils/fps.py.  The monotonic clock between step
calls, less the time between pause() and resume() (checkpoints), gives the
items per second of each step; the first `warmup_steps` are discarded.
"""

from __future__ import annotations

import time
from collections import deque


class FpsLogger:
    def __init__(self, warmup_steps: int = 3, window: int = 50, ema_alpha: float = 0.2):
        self.warmup_steps = warmup_steps
        self.window = deque(maxlen=window)
        self.ema_alpha = ema_alpha
        self.ema: float | None = None
        self._count = 0
        self._last: float | None = None
        self._paused_at: float | None = None

    def start(self):
        self._last = time.monotonic()

    def pause(self):
        if self._paused_at is None:
            self._paused_at = time.monotonic()

    def resume(self):
        if self._paused_at is not None and self._last is not None:
            self._last += time.monotonic() - self._paused_at
        self._paused_at = None

    def step(self, n_items: int = 1) -> float | None:
        """Record one step of n_items; returns the window's mean FPS."""
        now = time.monotonic()
        if self._last is None:
            self._last = now
            return None
        dt = now - self._last
        self._last = now
        self._count += 1
        if self._count <= self.warmup_steps or dt <= 0:
            return self.fps
        fps = n_items / dt
        self.window.append(fps)
        self.ema = fps if self.ema is None else (
            self.ema_alpha * fps + (1 - self.ema_alpha) * self.ema)
        return self.fps

    @property
    def fps(self) -> float | None:
        if not self.window:
            return None
        return sum(self.window) / len(self.window)

    @property
    def smoothed_fps(self) -> float | None:
        return self.ema
