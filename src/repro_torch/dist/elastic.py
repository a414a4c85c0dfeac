"""Straggler detection (the port's copy of ``StragglerDetector`` from
``repro.dist.elastic``; ``plan_mesh`` waits for the multi-process
communicator, ROADMAP.md §A).

``StragglerDetector`` is the training-loop watermark: a step slower than
``threshold`` x the rolling median of recent steps counts toward a streak;
``patience`` consecutive slow steps raise the flag (one-off hiccups such as
GC never fire it). The trainer surfaces the flag in its metrics.
"""

from __future__ import annotations

import collections
import statistics
import time
from typing import Callable, Deque, Optional


class StragglerDetector:
    """Windowed slow-step detector (see module docstring).

    ``clock`` is injectable for tests; defaults to ``time.monotonic``.
    """

    def __init__(self, window: int = 32, threshold: float = 2.0,
                 patience: int = 3,
                 clock: Callable[[], float] = time.monotonic):
        if window < 1 or patience < 1 or threshold <= 1.0:
            raise ValueError(
                f"bad config window={window} patience={patience} "
                f"threshold={threshold}")
        self.window = window
        self.threshold = threshold
        self.patience = patience
        self._clock = clock
        self._durations: Deque[float] = collections.deque(maxlen=window)
        self._t0: Optional[float] = None
        self._streak = 0

    def baseline(self) -> Optional[float]:
        """Rolling median of recent step durations (None until warmed up)."""
        if not self._durations:
            return None
        return statistics.median(self._durations)

    def step_start(self) -> None:
        self._t0 = self._clock()

    def step_end(self) -> bool:
        """Record the step; returns True when a persistent slowdown is on."""
        if self._t0 is None:
            raise RuntimeError("step_end() without step_start()")
        duration = self._clock() - self._t0
        self._t0 = None
        base = self.baseline()
        slow = base is not None and duration > self.threshold * base
        self._streak = self._streak + 1 if slow else 0
        self._durations.append(duration)
        return self._streak >= self.patience
