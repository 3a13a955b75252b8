"""Deterministic, seedable fault injection for the serving path.

A copy of ``repro.runtime.chaos`` (it needs nothing of JAX). The port's
``StreamEngine``, its image server (``launch/serve.py --chaos``) and its
sharded engine (``sharding/halo.py``) take a plan.

The serving stack advertises graceful degradation (retry, backend fallback,
elastic replan, shedding, quarantine — ``repro_torch.serve.guard``); this module
is the other half of that contract: a :class:`FaultPlan` that *causes* the
failures, at named sites, deterministically, so the self-healing machinery
is exercised by tests and by ``serve.py --chaos PLAN`` through the exact
same code paths.

Four fault kinds, mirroring what a real edge fleet sees:

  * :class:`DeviceLoss` — the device population shrinks at a given serving
    step (arbitrary loss patterns and times; ``--simulate-loss-at N`` is the
    special case ``loss@N``).
  * :class:`StepFail` — a (transient or persistent) failure raised at a
    named injection site (:meth:`FaultPlan.fire`): the per-request guard
    site (``"step"``), the engine entry (``"dispatch.edge"``), the sharded
    engine (``"halo.sharded_edge"``), or the fallback runner
    (``"fallback"``). Transient failures heal after ``count`` attempts
    (exercising the retry ladder); persistent ones never do (the port has
    no backend fallback, so they raise once the retries are spent).
  * :class:`Straggler` — artificial per-host delay: the named host's work
    runs ``delay_ms`` slow over a step window, which both drags the wall
    clock of any batch it rides in *and* shows up in the per-host
    ``StepMonitor`` timings, so ``StragglerPolicy`` actually flags it.
  * :class:`CorruptFrame` — a stream's frame arrives broken mid-stream
    (NaN/Inf pixels, wrong dtype, wrong shape); the engine must quarantine
    it per-stream instead of poisoning its batch group.

Injection is host-side Python: sites fire when the surrounding Python runs
— per request in the serve/guard loop.
The plan is stateful (transient failures are consumed as attempts arrive);
:meth:`FaultPlan.fresh` returns a reset copy so one parsed plan can drive a
faulty run and its fault-free reference.

Plan DSL (``serve.py --chaos``): ``;``- or ``,``-separated entries —

  * ``loss@STEP[=KEEP]`` — device loss before serving step STEP. ``KEEP``
    is a survivor fraction (``0.25``) or an explicit count (``2``);
    default ``0.5``.
  * ``fail@SITE:STEP[xCOUNT]`` — fail attempts ``[STEP, STEP+COUNT)`` at
    SITE (default count 1); ``xinf`` makes it persistent.
  * ``slow@HOST:DELAY_MS[@START[-STOP]]`` — straggle HOST (``s1`` = stream
    1, ``d1`` = device 1) by DELAY_MS per step over ``[START, STOP)``.
  * ``corrupt@STREAM:FRAME[=MODE]`` — corrupt that stream's FRAME-th frame;
    MODE in ``nan`` | ``inf`` | ``dtype`` | ``shape`` (default ``nan``).
  * ``seed=N`` — seed for the corruption noise pattern.

Example: ``"loss@4;fail@step:1x2;slow@s1:40;corrupt@0:3=nan"``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.runtime.fault import StepFailure

__all__ = [
    "InjectedFault",
    "DeviceLoss",
    "StepFail",
    "Straggler",
    "CorruptFrame",
    "FaultPlan",
    "CORRUPT_MODES",
]

CORRUPT_MODES = ("nan", "inf", "dtype", "shape")


class InjectedFault(StepFailure):
    """A failure raised by a :class:`FaultPlan` at an injection site.

    Subclasses :class:`~repro_torch.runtime.fault.StepFailure` so the existing
    fault-tolerance machinery (``FaultTolerantRunner``, the serve guard)
    treats injected and organic step failures identically.
    """


@dataclasses.dataclass(frozen=True)
class DeviceLoss:
    """Lose devices before serving step ``step``.

    ``keep`` is an explicit survivor count; else ``frac`` of the current
    population survives (at least one device always does).
    """

    step: int
    frac: float = 0.5
    keep: Optional[int] = None

    def survivors(self, n_devices: int) -> int:
        k = self.keep if self.keep is not None else int(n_devices * self.frac)
        return max(1, min(n_devices, k))


@dataclasses.dataclass(frozen=True)
class StepFail:
    """Fail attempts ``[step, step + count)`` at injection site ``site``.

    Attempts at a site are counted per :meth:`FaultPlan.fire` call, so a
    retried request advances the counter — ``count=2`` means the retry
    ladder succeeds on the third attempt. ``persistent=True`` fails every
    attempt from ``step`` on (the backend-fallback trigger).
    """

    site: str = "step"
    step: int = 0
    count: int = 1
    persistent: bool = False

    def hits(self, attempt: int) -> bool:
        if attempt < self.step:
            return False
        return self.persistent or attempt < self.step + self.count


@dataclasses.dataclass(frozen=True)
class Straggler:
    """Delay ``host``'s work by ``delay_ms`` per step over ``[start, stop)``.

    ``host`` names a :class:`~repro_torch.runtime.monitor.StepMonitor` key — the
    serving loops use ``"s<sid>"`` for streams and ``"d<idx>"`` for devices.
    """

    host: str
    delay_ms: float = 50.0
    start: int = 0
    stop: Optional[int] = None

    def delay_s(self, step: int) -> float:
        if step < self.start or (self.stop is not None and step >= self.stop):
            return 0.0
        return self.delay_ms / 1e3


@dataclasses.dataclass(frozen=True)
class CorruptFrame:
    """Corrupt stream ``stream``'s ``frame``-th source frame with ``mode``."""

    stream: int
    frame: int
    mode: str = "nan"

    def __post_init__(self):
        if self.mode not in CORRUPT_MODES:
            raise ValueError(
                f"corrupt mode {self.mode!r}; expected one of {CORRUPT_MODES}"
            )


Fault = Union[DeviceLoss, StepFail, Straggler, CorruptFrame]


class FaultPlan:
    """A deterministic schedule of injected faults.

    Construct programmatically from fault records or parse the compact DSL
    (module docstring). The plan is stateful — site attempt counters and
    consumed device-loss events — so tests that need to replay it (e.g. a
    faulty run vs its fault-free reference) should take :meth:`fresh`
    copies.
    """

    def __init__(self, faults: Sequence[Fault] = (), *, seed: int = 0):
        self.faults: Tuple[Fault, ...] = tuple(faults)
        self.seed = seed
        for f in self.faults:
            if not isinstance(f, (DeviceLoss, StepFail, Straggler, CorruptFrame)):
                raise TypeError(f"not a fault record: {f!r}")
        self._attempts: Dict[str, int] = {}
        self._losses_done: set = set()

    # -- construction ---------------------------------------------------------
    @classmethod
    def parse(cls, text: str) -> "FaultPlan":
        """Parse the ``--chaos`` DSL; raises ValueError with the bad token."""
        faults: List[Fault] = []
        seed = 0
        for token in (t.strip() for part in text.split(";") for t in part.split(",")):
            if not token:
                continue
            try:
                faults_or_seed = cls._parse_token(token)
            except (ValueError, IndexError) as e:
                raise ValueError(f"bad chaos token {token!r}: {e}") from None
            if isinstance(faults_or_seed, int):
                seed = faults_or_seed
            else:
                faults.append(faults_or_seed)
        return cls(faults, seed=seed)

    @staticmethod
    def _parse_token(token: str) -> Union[Fault, int]:
        if token.startswith("seed="):
            return int(token[len("seed="):])
        kind, _, rest = token.partition("@")
        if kind == "loss":
            step, _, keep = rest.partition("=")
            loss = DeviceLoss(step=int(step))
            if keep:
                if "." in keep:
                    loss = dataclasses.replace(loss, frac=float(keep))
                else:
                    loss = dataclasses.replace(loss, keep=int(keep))
            return loss
        if kind == "fail":
            site, _, at = rest.rpartition(":")
            site = site or "step"
            step, _, count = at.partition("x")
            if count == "inf":
                return StepFail(site=site, step=int(step), persistent=True)
            return StepFail(site=site, step=int(step),
                            count=int(count) if count else 1)
        if kind == "slow":
            host, _, spec = rest.partition(":")
            delay, _, window = spec.partition("@")
            start, _, stop = window.partition("-")
            return Straggler(
                host=host, delay_ms=float(delay),
                start=int(start) if start else 0,
                stop=int(stop) if stop else None,
            )
        if kind == "corrupt":
            target, _, mode = rest.partition("=")
            stream, _, frame = target.partition(":")
            return CorruptFrame(stream=int(stream), frame=int(frame),
                                mode=mode or "nan")
        raise ValueError(f"unknown fault kind {kind!r}")

    def fresh(self) -> "FaultPlan":
        """A reset copy: same faults and seed, no consumed state."""
        return FaultPlan(self.faults, seed=self.seed)

    def __repr__(self) -> str:
        return f"FaultPlan({list(self.faults)!r}, seed={self.seed})"

    def __bool__(self) -> bool:
        return bool(self.faults)

    # -- injection sites ------------------------------------------------------
    def fire(self, site: str) -> None:
        """One attempt at ``site``: raises :class:`InjectedFault` if a
        matching :class:`StepFail` schedules a failure for this attempt.

        This is the hook the engine entry points call — per request in the
        serve guard.
        """
        attempt = self._attempts.get(site, 0)
        self._attempts[site] = attempt + 1
        for f in self.faults:
            if isinstance(f, StepFail) and f.site == site and f.hits(attempt):
                raise InjectedFault(
                    f"injected failure at {site!r} (attempt {attempt}"
                    f"{', persistent' if f.persistent else ''})"
                )

    def attempts(self, site: str) -> int:
        """Attempts fired at ``site`` so far."""
        return self._attempts.get(site, 0)

    def device_loss(self, step: int) -> Optional[DeviceLoss]:
        """The loss event scheduled before serving step ``step``, if any.

        Each event fires once (consumed); multiple events at different
        steps model repeated shrinkage.
        """
        for f in self.faults:
            if isinstance(f, DeviceLoss) and f.step == step and f not in self._losses_done:
                self._losses_done.add(f)
                return f
        return None

    def delay_s(self, host: str, step: int) -> float:
        """Total injected straggler delay for ``host`` at ``step``, seconds."""
        return sum(
            f.delay_s(step) for f in self.faults
            if isinstance(f, Straggler) and f.host == host
        )

    def straggler_hosts(self) -> List[str]:
        return sorted({f.host for f in self.faults if isinstance(f, Straggler)})

    def corruption(self, stream: int, frame: int) -> Optional[str]:
        """Corruption mode scheduled for this stream/frame, or None."""
        for f in self.faults:
            if isinstance(f, CorruptFrame) and f.stream == stream and f.frame == frame:
                return f.mode
        return None

    # -- corruption synthesis -------------------------------------------------
    def corrupt(self, frame: np.ndarray, mode: str) -> np.ndarray:
        """A deterministically corrupted copy of ``frame``.

        ``nan``/``inf`` scatter non-finite pixels (the frame becomes f32 —
        u8 cannot hold them — so the dtype breaks too, as it would off a
        broken capture pipeline); ``dtype`` delivers f64; ``shape`` drops
        the last row. The pattern is a function of ``seed`` and the frame
        shape only, so a plan replays identically.
        """
        frame = np.asarray(frame)
        if mode not in CORRUPT_MODES:
            raise ValueError(f"corrupt mode {mode!r}; expected one of {CORRUPT_MODES}")
        if mode == "dtype":
            return frame.astype(np.float64)
        if mode == "shape":
            return frame[:-1] if frame.shape[0] > 1 else frame[:, :-1]
        bad = np.float32(math.nan if mode == "nan" else math.inf)
        out = frame.astype(np.float32)
        rng = np.random.default_rng(
            [self.seed, *(int(d) for d in frame.shape)]
        )
        flat = out.reshape(-1)
        n = max(1, flat.size // 64)
        flat[rng.choice(flat.size, size=n, replace=False)] = bad
        return out
