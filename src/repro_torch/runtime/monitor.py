"""Step-time monitoring + straggler detection.

At pod scale, per-host step times are collected out-of-band (here: recorded
directly); a host whose rolling median exceeds ``threshold`` x the fleet
median is flagged as a straggler, feeding the mitigation policy in
``runtime.stragglers``.
"""
from __future__ import annotations

import collections
import statistics
import time
from typing import Dict, List, Optional

__all__ = ["StepMonitor"]


class StepMonitor:
    def __init__(self, window: int = 16, threshold: float = 1.5):
        self.window = window
        self.threshold = threshold
        self._times: Dict[str, collections.deque] = {}
        self._t0: Optional[float] = None
        self.history: List[float] = []

    # -- wall-clock helpers for the local host ----------------------------------
    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, host: str = "host0") -> float:
        dt = time.perf_counter() - (self._t0 or time.perf_counter())
        self.record(host, dt)
        self.history.append(dt)
        return dt

    # -- fleet accounting ---------------------------------------------------------
    def record(self, host: str, duration: float) -> None:
        self._times.setdefault(host, collections.deque(maxlen=self.window)).append(duration)

    def host_median(self, host: str) -> float:
        d = self._times.get(host)
        return statistics.median(d) if d else 0.0

    def fleet_median(self) -> float:
        meds = [self.host_median(h) for h in self._times]
        return statistics.median(meds) if meds else 0.0

    def stragglers(self) -> List[str]:
        fleet = self.fleet_median()
        if fleet <= 0:
            return []
        return [h for h in self._times if self.host_median(h) > self.threshold * fleet]

    def summary(self) -> Dict[str, float]:
        return {h: self.host_median(h) for h in sorted(self._times)}
