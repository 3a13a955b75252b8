"""Fault tolerance: retrying step runner with checkpoint-restart semantics.

At 1000+ nodes, per-step failures (preemption, ICI flap, host OOM) are the
common case, not the exception. The runner wraps the train loop:

  * transient step failure -> bounded retries with exponential backoff;
  * persistent failure      -> restore the last checkpoint (params, optimizer,
    data-iterator state) and continue from there;
  * failure budget exhausted -> raise (orchestrator reschedules the job).

Reset semantics (the tested contract):

  * the per-step retry counter resets on success AND after a checkpoint
    restore (the restored step gets a full fresh retry budget);
  * ``total_failures`` is a lifetime budget for the runner — it never
    resets, so a slow persistent flap still exhausts it eventually;
  * a restore returns exactly what ``restore_fn`` produced: state *and*
    step may move backwards, and the runner resumes from that pair verbatim
    (no replay bookkeeping of its own).

Backoff is exponential with optional jitter:
``backoff_s * backoff_mult**(retry-1)``, capped at ``backoff_max_s``, plus
a uniform jitter of up to ``jitter`` of that value (decorrelates retry
storms across a fleet). The sequence is deterministic given the runner's
``seed``. The same policy object is exercised by the tests via injected
failures, and extended by the serving guard (``repro_torch.serve.guard``).
"""
from __future__ import annotations

import logging
import random
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

__all__ = ["FaultPolicy", "FaultTolerantRunner", "StepFailure"]

log = logging.getLogger("repro_torch.fault")


class StepFailure(RuntimeError):
    """A (possibly injected) step-level failure."""


@dataclass(frozen=True)
class FaultPolicy:
    """Retry/backoff policy shared by the train runner and the serve guard.

    ``backoff_s`` is the base delay before the first retry;
    ``backoff_mult`` grows it geometrically per retry, ``backoff_max_s``
    caps it, and ``jitter`` adds up to that fraction of the delay
    uniformly at random (0 = fully deterministic).
    """

    max_retries_per_step: int = 2
    max_total_failures: int = 16
    backoff_s: float = 0.0
    backoff_mult: float = 2.0
    backoff_max_s: float = 1.0
    jitter: float = 0.0

    def backoff_for(self, retry: int, rng: Optional[random.Random] = None) -> float:
        """Delay in seconds before retry number ``retry`` (1-based)."""
        if self.backoff_s <= 0 or retry < 1:
            return 0.0
        base = min(
            self.backoff_s * self.backoff_mult ** (retry - 1),
            self.backoff_max_s,
        )
        if self.jitter and rng is not None:
            base += rng.uniform(0.0, self.jitter * base)
        return base


class FaultTolerantRunner:
    def __init__(
        self,
        policy: FaultPolicy,
        *,
        restore_fn: Optional[Callable[[], Tuple[Any, int]]] = None,
        seed: int = 0,
    ):
        self.policy = policy
        self.restore_fn = restore_fn
        self.total_failures = 0
        self.restarts = 0
        self._rng = random.Random(seed)

    def run_step(self, step_fn: Callable[[Any, int], Any], state: Any, step: int):
        """Returns (new_state, step_after, result). On persistent failure,
        restores from checkpoint (state AND step may move backwards)."""
        retries = 0
        while True:
            try:
                result = step_fn(state, step)
                return state, step + 1, result
            except StepFailure as err:  # noqa: PERF203
                self.total_failures += 1
                retries += 1
                if self.total_failures > self.policy.max_total_failures:
                    raise RuntimeError(
                        f"failure budget exhausted ({self.total_failures})"
                    ) from err
                if retries <= self.policy.max_retries_per_step:
                    log.warning("step %d failed (%s); retry %d", step, err, retries)
                    delay = self.policy.backoff_for(retries, self._rng)
                    if delay:
                        time.sleep(delay)
                    continue
                if self.restore_fn is None:
                    raise
                log.warning("step %d failing persistently; restoring checkpoint", step)
                state, step = self.restore_fn()
                self.restarts += 1
                retries = 0
