"""Streaming video engine: continuous batching over per-stream edge state.

The port of ``repro.serve.streams``. A fixed population of slots, a queue
feeding them, per-slot carried state, one batched device call per step,
for video frames — the lane-detection workload the paper's kernel exists
for — where the carried state is temporal edge state:

  * **Slots + admission.** ``max_streams`` slots; :class:`StreamRequest`\\ s
    queue and are admitted as slots free up (a stream leaves when its frame
    source is exhausted). Streams join and leave mid-run without disturbing
    their neighbors — every slot owns an isolated
    :class:`~repro_torch.api.StreamState`.
  * **Continuous frame batching.** Each step serves every *due* stream
    (fps-paced on a deterministic virtual clock), grouping same-resolution
    streams into one batched :func:`~repro_torch.api.edge_detect_stream` call —
    ragged resolutions simply land in different groups. Per-slot states are
    concatenated for the call and split back after it, so batching is an
    execution detail, never a semantic one.
  * **Delta-skip dispatch.** Before computing, the engine runs the per-tile
    change test (``dispatch.stream_delta``) and host-checks it: a fully
    static group takes ``dispatch.edge_stream_cached`` — no kernel launch
    at all, just the cheap epilogue — while a partially changed group runs
    the masked-grid kernel K3 that recomputes only flagged tiles.
  * **Split timing.** Host→device transfer and engine compute are timed
    separately (a device synchronise ends the copy before the compute
    window opens), so the reported p50/p99 measure the engine, not PCIe.

Batched streams share their group's step latency — a reported per-stream
percentile is the latency of the batch the frame rode in, which is the
number a deadline cares about.

**Fault tolerance.** Every group serve runs under the degradation ladder
(:mod:`repro_torch.serve.guard`): bounded retry with backoff; a kernel
that still fails raises — the engine never swaps the plain PyTorch lane in
for a failing kernel on the card. Every pulled frame is screened —
corrupted frames (NaN/Inf, changed dtype/shape mid-stream) are quarantined
per-stream instead of poisoning their batch group, and a stream that keeps
blowing its latency budget sheds its oldest pending frame (hysteresis via
:class:`~repro_torch.serve.guard.Shedder`). A :class:`~repro_torch.runtime.monitor
.StepMonitor` + :class:`~repro_torch.runtime.stragglers.StragglerPolicy` watch
per-stream step times; a straggling stream is excluded into a solo batch
group after repeated strikes so it stops dragging its neighbors. The
engine's :class:`~repro_torch.serve.guard.Health` ledger accounts every
submitted frame as exactly one of served / retried / degraded / shed /
quarantined, and a :class:`~repro_torch.runtime.chaos.FaultPlan` injects
all of the above deterministically.

A stream whose *source iterator raises* mid-run is retired with the error
recorded in ``health.errors`` — one broken camera never takes down the
engine (frames it already served stay served and accounted).
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Union

import numpy as np
import torch

from repro_torch.api import EdgeConfig, StreamState, detect_layout
from repro_torch.kernels import dispatch
from repro_torch.kernels.edge import kernel_dtype
from repro_torch.runtime.chaos import FaultPlan
from repro_torch.runtime.monitor import StepMonitor
from repro_torch.runtime.stragglers import StragglerPolicy
from repro_torch.serve.guard import (
    GuardPolicy,
    Health,
    Outcome,
    Shedder,
    StepGuard,
    quarantine_reason,
)

__all__ = ["StreamRequest", "StreamStats", "StreamEngine"]

FrameSource = Union[Iterable[np.ndarray], Callable[[int], Optional[np.ndarray]]]


@dataclasses.dataclass
class StreamRequest:
    """One video stream: an id, a frame source, and an fps budget.

    ``frames`` is either an iterable of frames (``HW`` / ``HWC`` arrays,
    all the same shape and dtype) or a callable ``frame_index ->
    frame | None`` (``None`` ends the stream). ``fps`` paces the stream on
    the engine's virtual clock — streams with different rates interleave
    deterministically — and names the latency budget (one frame period)
    the stats report against.
    """

    sid: int
    frames: FrameSource
    fps: float = 30.0

    def __post_init__(self):
        if self.fps <= 0:
            raise ValueError(f"stream {self.sid}: fps={self.fps} must be > 0")

    def frame_iter(self) -> Iterator[np.ndarray]:
        if callable(self.frames):
            def gen():
                i = 0
                while True:
                    f = self.frames(i)
                    if f is None:
                        return
                    yield f
                    i += 1
            return gen()
        return iter(self.frames)


@dataclasses.dataclass
class StreamStats:
    """Per-stream serving record (returned by ``StreamEngine.run``).

    ``frames`` counts frames actually served (on any ladder rung);
    ``submitted`` counts every frame pulled from the source, so
    ``submitted == frames + shed + quarantined`` always holds — the
    per-stream slice of the engine's health invariant.
    """

    sid: int
    fps: float
    shape: tuple = ()
    frames: int = 0
    submitted: int = 0
    shed: int = 0                    # dropped under latency pressure
    quarantined: int = 0             # dropped as corrupt (NaN/dtype/shape)
    tiles_per_frame: int = 0
    skipped_tiles: int = 0
    cached_steps: int = 0            # steps served with no kernel launch
    transfer_ms: List[float] = dataclasses.field(default_factory=list)
    compute_ms: List[float] = dataclasses.field(default_factory=list)
    outputs: List[dict] = dataclasses.field(default_factory=list)  # collect=True

    @property
    def skip_rate(self) -> float:
        """Fraction of tiles delta-skipped after the cold first frame."""
        total = self.tiles_per_frame * max(0, self.frames - 1)
        return self.skipped_tiles / total if total else 0.0

    @property
    def budget_ms(self) -> float:
        return 1e3 / self.fps

    def percentile(self, q: float, *, which: str = "compute") -> float:
        xs = self.compute_ms if which == "compute" else self.transfer_ms
        return float(np.percentile(np.asarray(xs), q)) if xs else 0.0


@dataclasses.dataclass
class _Slot:
    req: StreamRequest
    it: Iterator[np.ndarray]
    state: Optional[StreamState]
    stats: StreamStats
    next_due: float
    shedder: Shedder
    pending: Optional[np.ndarray] = None   # next frame, pulled at admit
    pending_idx: int = -1                  # source index of ``pending``
    frame_idx: int = 0                     # source frames pulled so far
    dtype: Optional[np.dtype] = None       # pinned by the first good frame
    layout: str = "HW"
    solo: bool = False                     # excluded straggler: own group

    def group_key(self) -> tuple:
        key = (self.pending.shape, str(self.pending.dtype),
               self.state is None or not self.state.initialized)
        # An excluded straggler is batched alone so its injected/organic
        # slowness drags only itself, not its former groupmates.
        return key + (("solo", self.req.sid),) if self.solo else key


class StreamEngine:
    """Slot-scheduled streaming edge detection over many concurrent streams.

    ``config`` is the per-frame :class:`~repro_torch.api.EdgeConfig` (typically
    ``hysteresis=True, temporal=True, decay=...`` for detector traffic);
    it is resolved once and shared by every stream. ``collect=True`` keeps
    each stream's outputs (host copies of magnitude/edges + skip counts)
    on its stats record — for tests and small runs, not production.

    ``chaos`` threads a :class:`~repro_torch.runtime.chaos.FaultPlan` through
    the serving loop (site ``"step"`` per group serve, plus frame
    corruption, per-stream straggler delay, and device-loss events keyed on
    the engine step). ``guard`` tunes the retry rung; a group that fails
    past its retries raises (there is no backend fallback).
    ``device`` is where the streams run: ``None`` is the CUDA device (and
    raises without one), ``"cpu"`` runs the plain PyTorch lane.
    ``engine.health`` / ``engine.outcomes`` carry the run's accounting.

    Usage::

        eng = StreamEngine(EdgeConfig(temporal=True, decay=0.9))
        eng.submit(StreamRequest(sid=0, frames=camera0, fps=30))
        eng.submit(StreamRequest(sid=1, frames=camera1, fps=15))
        stats = eng.run()          # drive until every stream is exhausted
        print(eng.health.summary())
    """

    def __init__(
        self,
        config: Optional[EdgeConfig] = None,
        *,
        max_streams: int = 8,
        collect: bool = False,
        chaos: Optional[FaultPlan] = None,
        guard: Optional[GuardPolicy] = None,
        monitor: Optional[StepMonitor] = None,
        stragglers: Optional[StragglerPolicy] = None,
        device=None,
    ):
        self.config = (config or EdgeConfig()).resolved()
        self.device = dispatch.resolve_device(device)
        if max_streams < 1:
            raise ValueError(f"max_streams={max_streams} must be >= 1")
        self.max_streams = max_streams
        self.collect = collect
        self.chaos = chaos
        self.guard_policy = guard or GuardPolicy()
        self.slots: List[Optional[_Slot]] = [None] * max_streams
        self.queue: collections.deque = collections.deque()
        self.finished: List[StreamStats] = []
        self.clock = 0.0
        self.engine_step = 0
        self.health = Health(
            backend=dispatch.resolve_backend(self.config.backend, self.device)
        )
        self.outcomes: List[Outcome] = []
        self.monitor = monitor or StepMonitor(window=8)
        self.straggler_policy = stragglers or StragglerPolicy()
        self._excluded: set = set()
        self._guard = StepGuard(
            self._exec_group,
            policy=self.guard_policy,
            chaos=chaos,
            seed=chaos.seed if chaos is not None else 0,
        )

    # -- public API ----------------------------------------------------------
    def submit(self, req: StreamRequest) -> None:
        self.queue.append(req)

    def run(self, max_steps: int = 100_000) -> Dict[int, StreamStats]:
        """Drive until queue + slots drain; returns stats keyed by sid."""
        for _ in range(max_steps):
            if not self.step():
                break
        return {s.sid: s for s in self.finished}

    def active(self) -> List[int]:
        return [s.req.sid for s in self.slots if s is not None]

    # -- frame intake: corruption screen + quarantine + shedding -------------
    def _pull(self, slot: _Slot) -> Optional[np.ndarray]:
        """Next *servable* frame for ``slot`` (None = stream over).

        Every frame pulled from the source counts as submitted; the ones
        that never reach a batch are terminally accounted right here —
        corrupted frames are quarantined against the stream's pinned
        shape/dtype contract (plus the intrinsic NaN/Inf and invalid-dtype
        checks), and while the stream's :class:`Shedder` says it is behind
        budget, the oldest pending frame is shed to let it catch up.
        """
        sid = slot.req.sid
        while True:
            try:
                frame = next(slot.it, None)
            except Exception as err:  # noqa: BLE001 — isolate broken sources
                self.health.errors.append(
                    f"stream {sid}: source raised {type(err).__name__}: {err}"
                )
                return None
            if frame is None:
                return None
            idx = slot.frame_idx
            slot.frame_idx += 1
            self.health.submitted += 1
            slot.stats.submitted += 1
            frame = np.asarray(frame)
            if self.chaos is not None:
                mode = self.chaos.corruption(sid, idx)
                if mode is not None:
                    frame = self.chaos.corrupt(frame, mode)
            reason = quarantine_reason(
                frame,
                shape=slot.stats.shape or None,
                dtype=slot.dtype,
            )
            if reason is not None:
                self._account("quarantined", slot, idx, detail=reason)
                slot.stats.quarantined += 1
                continue
            if slot.shedder.shedding:
                self._account("shed", slot, idx, detail="latency budget")
                slot.stats.shed += 1
                slot.shedder.shed_one()
                continue
            slot.pending_idx = idx
            return frame

    def _account(self, kind: str, slot: _Slot, idx: int, *,
                 detail: str = "", attempts: int = 0,
                 latency_ms: float = 0.0) -> None:
        self.health.record(kind)
        self.outcomes.append(Outcome(
            kind=kind, step=self.engine_step, stream=slot.req.sid,
            frame=idx, attempts=attempts, latency_ms=latency_ms,
            backend=self.health.backend if kind not in ("shed", "quarantined")
            else None,
            detail=detail,
        ))

    # -- internals -----------------------------------------------------------
    def _admit(self) -> None:
        for i in range(self.max_streams):
            if self.slots[i] is not None or not self.queue:
                continue
            req = self.queue.popleft()
            slot = _Slot(
                req=req, it=req.frame_iter(), state=None,
                stats=StreamStats(sid=req.sid, fps=req.fps),
                next_due=self.clock,
                shedder=Shedder(shed_after=self.guard_policy.shed_after),
            )
            first = self._pull(slot)
            if first is None:          # empty / all-quarantined: trivially done
                self.finished.append(slot.stats)
                continue
            slot.pending = first
            slot.stats.shape = first.shape   # pins the stream's contract
            slot.dtype = first.dtype
            slot.layout = "N" + detect_layout(first.shape)
            self.slots[i] = slot

    def _retire(self, i: int) -> None:
        self.finished.append(self.slots[i].stats)
        self.slots[i] = None

    def step(self) -> bool:
        """Serve every due stream once; returns False when fully drained."""
        self._admit()
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            return bool(self.queue)
        if self.chaos is not None:
            loss = self.chaos.device_loss(self.engine_step)
            if loss is not None:
                # Single-device streaming with nothing compiled to rebuild:
                # the loss is only counted.
                self.health.replans += 1
        self.clock = min(self.slots[i].next_due for i in active)
        due = [i for i in active
               if self.slots[i].next_due <= self.clock + 1e-9]
        groups: Dict[tuple, List[int]] = collections.defaultdict(list)
        for i in due:
            groups[self.slots[i].group_key()].append(i)
        for members in groups.values():
            self._serve_group(members)
        self._police_stragglers()
        self.engine_step += 1
        for i in due:
            slot = self.slots[i]
            if slot is None:
                continue                            # retired in this step
            slot.next_due += 1.0 / slot.req.fps
            slot.pending = self._pull(slot)
            if slot.pending is None:
                self._retire(i)
        return True

    def _police_stragglers(self) -> None:
        """Feed the monitor's verdicts to the mitigation policy.

        A stream flagged ``strikes_to_exclude`` steps in a row is moved to
        a solo batch group — the streaming analog of dropping a straggler
        host from the mesh: its neighbors stop paying its latency, it
        keeps being served (and shed, if it cannot keep up even alone).
        """
        flagged = self.monitor.stragglers()
        for h in flagged:
            if h not in self.health.stragglers:
                self.health.stragglers.append(h)
        decision = self.straggler_policy.step(self.monitor)
        for host in decision["exclude"]:
            if host in self._excluded:
                continue
            self._excluded.add(host)
            self.health.excluded.append(host)
            for s in self.slots:
                if s is not None and f"s{s.req.sid}" == host:
                    s.solo = True

    def _exec_group(self, frames, state, layout):
        """One guarded group serve: delta host-check, cached or masked step.

        Runs under :class:`~repro_torch.serve.guard.StepGuard`. Synchronises
        the device so failures surface here, inside the retry rung.
        """
        cfg = self.config
        rgb = layout.endswith("C")
        if state.initialized:
            changed, _skipped = dispatch.stream_delta(frames, state, cfg, rgb=rgb)
            static = not bool(changed.any())
        else:
            changed, static = None, False
        if static:
            # Whole group unchanged: skip the kernel launch outright — the
            # cached maps ARE this frame's outputs; only the (temporal)
            # epilogue runs. Bit-identical to the masked kernel on the
            # same frames.
            result, new_state = dispatch.edge_stream_cached(cfg, state, layout=layout)
        else:
            result, new_state = dispatch.edge_stream(
                frames, cfg, state, layout=layout, changed=changed, device=self.device
            )
        self._sync()
        return result, new_state, static

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _serve_group(self, members: List[int]) -> None:
        slots = [self.slots[i] for i in members]
        layout = slots[0].layout

        host = torch.from_numpy(np.stack([s.pending for s in slots]))
        t0 = time.perf_counter()
        frames = kernel_dtype(host.to(self.device))
        self._sync()
        transfer_ms = (time.perf_counter() - t0) * 1e3

        t1 = time.perf_counter()
        state = self._group_state(slots, frames)
        (result, new_state, cached), kind, attempts = self._guard(
            frames, state, layout
        )
        compute_ms = (time.perf_counter() - t1) * 1e3
        self.health.retries += attempts

        # Injected straggler drag: the slowest member delays the whole
        # batch (shared wall clock), but the monitor is fed each member's
        # own time — base plus its own injected delay — so detection
        # attributes the lag to the right stream, not the whole group.
        lag = 0.0
        if self.chaos is not None:
            delays = [self.chaos.delay_s(f"s{s.req.sid}", s.stats.frames)
                      for s in slots]
            lag = max(delays)
            if lag > 0:
                time.sleep(lag)
        else:
            delays = [0.0] * len(slots)
        group_ms = compute_ms + lag * 1e3

        skipped = result.skipped.cpu().numpy()
        for b, s in enumerate(slots):
            s.state = new_state.map(lambda a, b=b: a[b:b + 1])
            st = s.stats
            st.frames += 1
            st.tiles_per_frame = s.state.tiles
            if cached:
                st.cached_steps += 1
            if st.frames > 1:            # frame 0 is the cold cache fill
                st.skipped_tiles += int(skipped[b])
            st.transfer_ms.append(transfer_ms)
            st.compute_ms.append(group_ms)
            self.monitor.record(
                f"s{s.req.sid}", compute_ms / 1e3 + delays[b]
            )
            self._account(kind, s, s.pending_idx, attempts=attempts,
                          latency_ms=group_ms,
                          detail=self._guard.last_error or "" if attempts
                          else "")
            if st.frames > self.guard_policy.warm_frames:
                budget = self.guard_policy.deadline_ms or st.budget_ms
                if s.shedder.observe(group_ms, budget):
                    self.health.deadline_violations += 1
            if self.collect:
                st.outputs.append(self._host_outputs(result, b))

    def _group_state(self, slots: List[_Slot], frames) -> StreamState:
        """Concatenate the members' states for one batched call."""
        if slots[0].state is None:
            h, w = (frames.shape[1:3])
            rgb = frames.ndim == 4
            return StreamState.init(
                len(slots), h, w, self.config, rgb=rgb, dtype=frames.dtype,
                device=self.device,
            )
        if len(slots) == 1:
            return slots[0].state
        return StreamState.concat([s.state for s in slots])

    @staticmethod
    def _host_outputs(result, b: int) -> dict:
        out = {
            "magnitude": result.magnitude[b].cpu().numpy(),
            "skipped": int(result.skipped[b]),
        }
        if result.edges is not None:
            out["edges"] = result.edges[b].cpu().numpy()
        return out
