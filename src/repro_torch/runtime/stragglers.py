"""Straggler mitigation policy.

Consumes ``StepMonitor.stragglers()`` and produces actions:
  * ``rebalance``: shrink the flagged host's data shard (work stealing) by
    ``shrink_factor`` — returned as a per-host batch-fraction map that the
    data pipeline applies on the next rebatch;
  * ``exclude``: after ``strikes`` consecutive flags, advise dropping the host
    (an elastic re-mesh; the stream engine moves the stream into a solo
    batch group).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

from repro_torch.runtime.monitor import StepMonitor

__all__ = ["StragglerPolicy"]


@dataclass
class StragglerPolicy:
    strikes_to_exclude: int = 3
    shrink_factor: float = 0.5
    _strikes: Dict[str, int] = field(default_factory=dict)

    def step(self, monitor: StepMonitor) -> Dict[str, object]:
        flagged = set(monitor.stragglers())
        for h in list(self._strikes):
            if h not in flagged:
                self._strikes[h] = 0
        for h in flagged:
            self._strikes[h] = self._strikes.get(h, 0) + 1

        exclude: List[str] = [
            h for h, s in self._strikes.items() if s >= self.strikes_to_exclude
        ]
        fractions = {
            h: (self.shrink_factor if h in flagged and h not in exclude else 1.0)
            for h in monitor.summary()
        }
        return {"exclude": sorted(exclude), "batch_fractions": fractions}
