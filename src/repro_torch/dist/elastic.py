"""Elasticity (the port's copy of ``repro.dist.elastic``): plan the mesh
over the ranks a job can start, and flag persistent stragglers.

``plan_mesh`` answers "the job asked for a ``model`` axis of M over W
ranks: what do we actually run?": keep the model axis at its target when
the pool can host one replica (degrading it to the largest refinable size
that fits when the pool is smaller), absorb the remainder by shrinking the
``data`` axis, and strand the leftover ranks. The model axis must stay a
StarTrail-refinable size (a multiple of ``min_model`` = 4, the smallest
C = 2 ring), so a pool too small to host one model replica raises. The
process launcher (``launch.train --backend gloo|nccl``, ``dist.procs``)
fits its (data, model) split to the ranks it can start with it.

``StragglerDetector`` is the training-loop watermark: a step slower than
``threshold`` x the rolling median of recent steps counts toward a streak;
``patience`` consecutive slow steps raise the flag (one-off hiccups such as
GC never fire it). The trainer surfaces the flag in its metrics.
"""

from __future__ import annotations

import collections
import dataclasses
import statistics
import time
from typing import Callable, Deque, Optional


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """A runnable (data, model) split of a pool of ranks."""

    data: int
    model: int
    world: int             # ranks in the pool when planned

    @property
    def devices(self) -> int:
        """Ranks actually used; ``world - devices`` are stranded."""
        return self.data * self.model

    @property
    def stranded(self) -> int:
        return self.world - self.devices


def plan_mesh(world: int, *, model_axis_target: int,
              min_model: int = 4) -> MeshPlan:
    """Plan a ``(data, model)`` mesh over a pool of ``world`` ranks.

    Keeps ``model`` at ``model_axis_target`` whenever the pool can host at
    least one replica; otherwise degrades it to the largest multiple of
    ``min_model`` that fits. Raises ``ValueError`` when the pool cannot
    host ``min_model`` ranks."""
    if world < 1:
        raise ValueError(f"world must be positive, got {world}")
    model = (min(model_axis_target, world) // min_model) * min_model
    if model < min_model:
        raise ValueError(
            f"pool of {world} devices cannot host a model axis >= "
            f"{min_model} (target {model_axis_target})")
    return MeshPlan(data=world // model, model=model, world=world)


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
