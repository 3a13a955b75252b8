"""Graceful-degradation ladder for the serving path.

A real-time edge detector treats a missed or late frame as a correctness
failure, so a serving step never just throws — it walks a ladder, cheapest
rung first, and every submitted frame ends in exactly one accounted
outcome:

  1. **Bounded retry** with exponential backoff + jitter
     (:class:`~repro_torch.runtime.fault.FaultPolicy`) — transient failures heal
     in place; the frame's outcome is ``retried``.
  2. **Fallback** — where the caller hands :class:`StepGuard` a
     ``fallback`` callable, a persistently failing primary flips to it
     permanently; outcomes become ``degraded``. The image server and the
     stream engine pass none: a CUDA kernel that keeps failing raises, and
     the plain PyTorch lane never stands in for it.
  3. **Elastic replan** — a device loss or an excluded straggler rebuilds
     the image server's mesh on the survivors
     (``runtime.elastic.plan_image_mesh``) and re-warms outside the
     latency window; serving continues at lower throughput. The stream
     engine counts a device loss as a replan (it has no mesh).
  4. **Load shedding** — a stream that keeps blowing its latency budget
     drops its oldest pending frame(s) (:class:`Shedder`, with hysteresis
     so recovery is observable rather than oscillating); outcomes ``shed``.
  5. **Quarantine** — a corrupted frame (NaN/Inf pixels, wrong
     dtype/shape mid-stream) is dropped per-stream before it can poison
     its batch group (:func:`quarantine_reason`); outcomes ``quarantined``.

:class:`StepGuard` implements rungs 1–2 around any step callable;
:class:`Shedder`/:func:`quarantine_reason` are the per-stream pieces the
stream engine composes; :class:`Health` is the run-wide ledger the serve
CLI prints — its invariant is ``served + retried + degraded + shed +
quarantined == submitted`` (no frame unaccounted).

Fault injection (:mod:`repro_torch.runtime.chaos`) threads through the
same entry points: the guard fires the plan's ``"step"``/``"fallback"``
sites per attempt.

The port of ``repro.serve.guard``. The reference's servers fill rung 2
with their ``pallas → xla`` fallback; the port's leave it empty.
"""
from __future__ import annotations

import dataclasses
import logging
import random
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.runtime.chaos import FaultPlan
from repro_torch.runtime.fault import FaultPolicy

__all__ = [
    "OUTCOMES",
    "GuardPolicy",
    "Outcome",
    "Health",
    "StepGuard",
    "Shedder",
    "quarantine_reason",
]

log = logging.getLogger("repro_torch.guard")

# Terminal outcomes of one submitted frame/request, in ladder order.
OUTCOMES = ("served", "retried", "degraded", "shed", "quarantined")


@dataclasses.dataclass(frozen=True)
class GuardPolicy:
    """Degradation-ladder knobs for one serving loop.

    ``fault`` is the retry/backoff policy (rung 1). ``deadline_ms`` is the
    per-step latency deadline; ``None`` means "the stream's own fps
    budget" in streaming mode and "off" in batch mode. ``shed_after`` is
    the hysteresis entry threshold (consecutive-ish budget violations
    before shedding starts; see :class:`Shedder`). ``warm_frames`` exempts
    each stream's first N served frames from deadline accounting — they
    pay the kernels' first-use build, which is not a serving regression.
    """

    fault: FaultPolicy = FaultPolicy(
        max_retries_per_step=2, backoff_s=0.005, backoff_mult=2.0,
        backoff_max_s=0.25, jitter=0.1,
    )
    deadline_ms: Optional[float] = None
    shed_after: int = 3
    warm_frames: int = 2


@dataclasses.dataclass(frozen=True)
class Outcome:
    """One submitted frame's terminal outcome."""

    kind: str                      # one of OUTCOMES
    step: int                      # engine step / request index
    stream: Optional[int] = None   # stream sid (streaming mode)
    frame: Optional[int] = None    # per-stream source frame index
    attempts: int = 0              # retries burned before success
    backend: Optional[str] = None  # backend that served it
    latency_ms: float = 0.0
    detail: str = ""               # quarantine reason / failure text


@dataclasses.dataclass
class Health:
    """Run-wide serving ledger: outcome counts + self-healing events.

    ``submitted`` counts every frame pulled from a source (or request
    built); the outcome counts must add back up to it —
    :attr:`unaccounted` == 0 is the serving invariant the chaos CI lane
    asserts for recoverable fault plans.
    """

    backend: Optional[str] = None
    counts: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {k: 0 for k in OUTCOMES}
    )
    submitted: int = 0
    retries: int = 0               # individual retry attempts burned
    replans: int = 0               # device-loss events handled
    deadline_violations: int = 0
    degraded: bool = False         # backend fallback engaged
    stragglers: List[str] = dataclasses.field(default_factory=list)
    excluded: List[str] = dataclasses.field(default_factory=list)
    errors: List[str] = dataclasses.field(default_factory=list)

    def record(self, kind: str) -> None:
        if kind not in self.counts:
            raise ValueError(f"unknown outcome {kind!r}; expected {OUTCOMES}")
        self.counts[kind] += 1

    @property
    def accounted(self) -> int:
        return sum(self.counts.values())

    @property
    def unaccounted(self) -> int:
        return self.submitted - self.accounted

    def summary(self) -> str:
        c = self.counts
        parts = [
            f"submitted={self.submitted}",
            " ".join(f"{k}={c[k]}" for k in OUTCOMES),
            f"unaccounted={self.unaccounted}",
        ]
        if self.retries:
            parts.append(f"retries={self.retries}")
        if self.replans:
            parts.append(f"replans={self.replans}")
        if self.deadline_violations:
            parts.append(f"deadline_violations={self.deadline_violations}")
        if self.backend:
            parts.append(
                f"backend={self.backend}{' (degraded)' if self.degraded else ''}"
            )
        if self.stragglers:
            parts.append(f"stragglers={self.stragglers}")
        if self.excluded:
            parts.append(f"excluded={self.excluded}")
        if self.errors:
            parts.append(f"errors={len(self.errors)}")
        return "health: " + " ".join(parts)


class StepGuard:
    """Rungs 1–2 of the ladder around one step callable.

    ``primary`` runs the configured backend; ``fallback`` (optional) is
    a bit-exact twin to flip to. A call retries transient failures with the
    policy's backoff; once the per-step retry budget is exhausted the
    guard flips to the fallback *permanently* (``degraded``) — a kernel
    that failed persistently once is not re-trusted mid-run — and raises
    only if the fallback fails persistently too (or none exists).

    Returns ``(result, kind, attempts)`` where ``kind`` classifies the
    serving rung: ``"served"`` (first try, primary), ``"retried"``
    (succeeded after >= 1 retry), ``"degraded"`` (served by the
    fallback). A :class:`~repro_torch.runtime.chaos.FaultPlan` fires its
    ``site``/``fallback_site`` per attempt, which is how injected kernel
    failures reach per-request granularity.
    """

    def __init__(
        self,
        primary: Callable,
        *,
        fallback: Optional[Callable] = None,
        policy: Optional[GuardPolicy] = None,
        chaos: Optional[FaultPlan] = None,
        site: str = "step",
        fallback_site: str = "fallback",
        seed: int = 0,
        sleep: Callable[[float], None] = time.sleep,
    ):
        self.primary = primary
        self.fallback = fallback
        self.policy = policy or GuardPolicy()
        self.chaos = chaos
        self.site = site
        self.fallback_site = fallback_site
        self.degraded = False
        self.failovers = 0
        self.retries_total = 0
        self.last_error: Optional[str] = None
        self._rng = random.Random(seed)
        self._sleep = sleep

    def __call__(self, *args, **kw) -> Tuple[object, str, int]:
        attempts = 0
        fp = self.policy.fault
        while True:
            runner = self.fallback if self.degraded else self.primary
            site = self.fallback_site if self.degraded else self.site
            try:
                if self.chaos is not None:
                    self.chaos.fire(site)
                out = runner(*args, **kw)
            except Exception as err:  # noqa: BLE001 — the ladder IS the handler
                self.last_error = f"{type(err).__name__}: {err}"
                attempts += 1
                self.retries_total += 1
                if attempts <= fp.max_retries_per_step:
                    delay = fp.backoff_for(attempts, self._rng)
                    log.warning(
                        "%s failed (%s); retry %d/%d after %.3fs",
                        site, err, attempts, fp.max_retries_per_step, delay,
                    )
                    if delay:
                        self._sleep(delay)
                    continue
                if not self.degraded and self.fallback is not None:
                    log.warning(
                        "%s failing persistently (%s); degrading to the "
                        "fallback backend permanently", site, err,
                    )
                    self.degraded = True
                    self.failovers += 1
                    attempts = 0
                    continue
                raise
            kind = ("degraded" if self.degraded
                    else "retried" if attempts else "served")
            return out, kind, attempts


@dataclasses.dataclass
class Shedder:
    """Per-stream latency-budget load shedding with hysteresis.

    Each served frame over its deadline adds a violation; each frame under
    it removes one. Shedding *enters* at ``shed_after`` violations and
    *exits* only when the count drains back to zero — each shed frame
    drains one — so the shed/serve boundary cannot oscillate: a violation
    streak of length N sheds ~N frames, then serving resumes and recovery
    is observable in the outcome record.
    """

    shed_after: int = 3
    violations: int = 0
    shedding: bool = False

    def observe(self, latency_ms: float, budget_ms: float) -> bool:
        """Account one served frame's latency; returns True on violation."""
        over = latency_ms > budget_ms
        if over:
            self.violations += 1
            if self.violations >= self.shed_after:
                self.shedding = True
        else:
            self.violations = max(0, self.violations - 1)
            if self.violations == 0:
                self.shedding = False
        return over

    def shed_one(self) -> None:
        """Account one shed frame (drains the violation debt)."""
        self.violations = max(0, self.violations - 1)
        if self.violations == 0:
            self.shedding = False


# Dtypes the kernel path accepts natively (see kernels.edge.kernel_dtype);
# anything else mid-stream is a broken capture pipeline, not a request.
_VALID_KINDS = ("u", "i", "f", "b")


def quarantine_reason(
    frame: np.ndarray,
    *,
    shape: Optional[Tuple[int, ...]] = None,
    dtype=None,
) -> Optional[str]:
    """Why ``frame`` must be quarantined, or ``None`` if it is servable.

    Intrinsic checks (always): non-finite pixels in float frames, and
    dtypes outside the kernel contract (f64 would be silently downcast,
    which hides corruption instead of surfacing it). Contract checks
    (when the stream's pinned ``shape``/``dtype`` are given): any
    mid-stream change of either. The first frame of a stream pins the
    contract, so frame-0 shape corruption is undetectable by construction
    — a real deployment pins it from stream metadata instead.
    """
    frame = np.asarray(frame)
    if frame.dtype.kind not in _VALID_KINDS or frame.dtype.itemsize > 4:
        return f"invalid dtype {frame.dtype}"
    if shape is not None and frame.shape != tuple(shape):
        return f"shape changed {tuple(shape)} -> {frame.shape}"
    if dtype is not None and frame.dtype != dtype:
        return f"dtype changed {np.dtype(dtype)} -> {frame.dtype}"
    if frame.dtype.kind == "f" and not np.isfinite(frame).all():
        return "non-finite pixels (NaN/Inf)"
    return None
