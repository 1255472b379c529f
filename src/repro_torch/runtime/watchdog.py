"""Straggler watchdog: step times classified against a robust running
estimate.

A straggler shows up as a step-time outlier (a slow rank drags every
collective).  The watchdog keeps the median and the median absolute
deviation (MAD) of a sliding window of step times and flags a step longer
than ``median + threshold · MAD``, once the window holds 5 steps; after
``patience`` flagged steps in a row it calls ``on_straggle`` (the trainer
prints; a deployment would checkpoint early and resize through
``repro_torch.runtime.elastic``).  The policy is plain arithmetic, tested
with synthetic step times.

Port of ``repro.runtime.watchdog``, the same policy.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable

__all__ = ["StepStats", "StragglerWatchdog"]


@dataclasses.dataclass
class StepStats:
    step: int
    duration_s: float
    median_s: float
    is_straggler: bool


class StragglerWatchdog:
    def __init__(self, window: int = 50, threshold: float = 3.0,
                 patience: int = 3,
                 on_straggle: Callable[[StepStats], None] | None = None):
        self.window = deque(maxlen=window)
        self.threshold = threshold
        self.patience = patience
        self.on_straggle = on_straggle
        self.consecutive = 0
        self.history: list = []
        self._t0: float | None = None

    @property
    def straggles(self) -> int:
        """Steps flagged so far."""
        return sum(s.is_straggler for s in self.history)

    def start_step(self):
        self._t0 = time.monotonic()

    def end_step(self, step: int, duration_s: float | None = None) -> StepStats:
        """Classify step ``step`` (its time since ``start_step``, or
        ``duration_s``) against the window before it, then add it."""
        if duration_s is None:
            assert self._t0 is not None
            duration_s = time.monotonic() - self._t0
        med = self._median() if self.window else duration_s
        mad = self._mad(med) if len(self.window) >= 5 else med
        is_straggler = (len(self.window) >= 5
                        and duration_s > med + self.threshold * max(mad, 1e-9))
        self.window.append(duration_s)
        stats = StepStats(step=step, duration_s=duration_s, median_s=med,
                          is_straggler=is_straggler)
        self.history.append(stats)
        if is_straggler:
            self.consecutive += 1
            if self.consecutive >= self.patience and self.on_straggle:
                self.on_straggle(stats)
                self.consecutive = 0
        else:
            self.consecutive = 0
        return stats

    def _median(self) -> float:
        s = sorted(self.window)
        n = len(s)
        return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])

    def _mad(self, med: float) -> float:
        devs = sorted(abs(x - med) for x in self.window)
        n = len(devs)
        return devs[n // 2] if n % 2 else 0.5 * (devs[n // 2 - 1] + devs[n // 2])
