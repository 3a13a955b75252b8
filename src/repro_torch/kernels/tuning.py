"""Block-shape tuner for the CUDA edge kernels, and its JSON cache.

A copy of ``repro.kernels.tuning`` with a Hopper cost model. The knobs are
the CTA output tile ``(block_h, block_w)`` and the K2 ring depth (0 = K1).
This module

  * enumerates the legal tiles for an image, operator and depth
    (:func:`legal_block_shapes`): the tile must fit, within ``SMEM_MAX``,
    the shared memory that every kernel it may serve reserves with NMS on
    (:func:`tile_fits`: K1 and K3 at ``edge.window_smem_bytes``, K2 at
    ``edge.pipelined_smem_bytes``), its width must be a multiple of the
    32-thread warp on the ``cuda`` backend, and it must not be much bigger
    than the image;
  * times each candidate (:func:`measure_us`: warm calls, then best-of
    ``iters``, with a ``torch.cuda.synchronize()`` on the card), and
  * keeps the winner in a JSON cache keyed by ``(backend, dtype, operator,
    variant, padding, layout, H, W, devices, mesh, precision, depth,
    plan)`` (:class:`TuningCache`), which ``kernels.dispatch`` consults.

The key and the file are the reference's schema v6, so a file written by
either package reads in the other; ``backend`` is ``cuda`` or ``torch``
here, the plan slot is ``filters.plan_identity(plan)`` for a stencil plan
and ``-`` for a single operator, and ``devices``/``mesh`` are ``1``/``1x1x1``
for a single-device call and the mesh's size and ``DxRxC`` shape for a
sharded one (``kernels.dispatch`` resolves that tile against the
halo-extended block each shard's kernel sees). Older files
migrate on load exactly as in the reference (v1 -> ... -> v6) and are
rewritten as v6 by the next :meth:`TuningCache.save`. A TPU tuning means
nothing on the card and is never carried across: the backends differ, so
the keys do.

Cache location: ``$REPRO_TUNE_CACHE`` if set, else
``~/.cache/repro_torch/sobel_blocks.json``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.edge import (
    SMEM_MAX,
    pipelined_smem_bytes,
    window_smem_bytes,
)
from repro_torch.kernels.tiling import halo_amplification

__all__ = [
    "TuneKey",
    "TuningCache",
    "default_cache_path",
    "measure_us",
    "legal_block_shapes",
    "tile_smem_bytes",
    "tile_fits",
    "sweep",
    "autotune",
    "get_default_cache",
]

# Candidate tiles. Rows of 8 keep a warp's stores in whole rows; widths are
# multiples of the 32-thread warp, so stores coalesce.
_CAND_H = (8, 16, 32, 64, 128, 256)
_CAND_W = (32, 64, 128, 256, 512, 1024)


@dataclasses.dataclass(frozen=True)
class TuneKey:
    """Cache key: one tuned workload shape."""

    backend: str      # cuda | torch
    dtype: str        # input dtype name as the kernel sees it (uint8 | float32)
    operator: str     # registered operator name (sobel5 | sobel3 | scharr3 | ...)
    variant: str
    h: int            # frame H/W as the user sees it
    w: int
    padding: str = "reflect"   # reflect | edge | zero
    layout: str = "gray"       # gray | rgb
    devices: int = 1           # devices the call spans (1 = single-device)
    mesh: str = "1x1x1"        # image mesh shape "DxRxC" (data x row x col)
    precision: str = "f32"     # resolved lane: f32 | int
    depth: int = 0             # requested pipeline depth (0 = K1)
    plan: str = "-"            # plan identity, "-" for a single operator

    def to_str(self) -> str:
        return (
            f"{self.backend}/{self.dtype}/{self.operator}/{self.variant}"
            f"/{self.padding}/{self.layout}/{self.h}x{self.w}"
            f"/{self.devices}/{self.mesh}/{self.precision}/{self.depth}"
            f"/{self.plan}"
        )


@contextlib.contextmanager
def _file_lock(path: str):
    """Advisory exclusive lock on ``path`` (created on demand).

    ``flock`` attaches to the open file description, so every locker —
    process or thread — opens its own handle and they serialize. On
    platforms without ``fcntl`` this degrades to no lock: saves stay
    atomic (temp + rename), they just lose merge-with-peers.
    """
    try:
        import fcntl
    except ImportError:  # pragma: no cover — non-POSIX best effort
        yield
        return
    with open(path, "a") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(lk, fcntl.LOCK_UN)


# v1/v2 key size segments ("5x5") -> operator registry names.
_SIZE_TO_OPERATOR = {"3x3": "sobel3", "5x5": "sobel5", "7x7": "sobel7"}


def _migrate_v1_key(key: str) -> Optional[str]:
    """v1 keys were ``backend/dtype/SxS/variant/HxW``; the v1 kernels always
    behaved as reflect padding on grayscale input, so that is the slot their
    tunings carry over to (then through v2->v3->v4). Returns None for
    unrecognizable keys."""
    parts = key.split("/")
    if len(parts) != 5:
        return None
    backend, dtype, size, variant, hw = parts
    return _migrate_v2_key(f"{backend}/{dtype}/{size}/{variant}/reflect/gray/{hw}")


def _migrate_v2_key(key: str) -> Optional[str]:
    """v2 keys carried an ``SxS`` size segment; v3 names the operator — the
    v2 kernels were the Sobel family, so ``5x5 -> sobel5`` etc."""
    parts = key.split("/")
    if len(parts) != 7:
        return None
    op = _SIZE_TO_OPERATOR.get(parts[2])
    if op is None:
        return None
    parts[2] = op
    return _migrate_v3_key("/".join(parts))


def _migrate_v3_key(key: str) -> Optional[str]:
    """v3 keys predate the multi-device engine — every tuning was taken on
    one device, so they land in the ``1/1x1x1`` slot of the v4 key space
    (then through v4->v5)."""
    parts = key.split("/")
    if len(parts) != 7:
        return None
    return _migrate_v4_key("/".join(parts + ["1", "1x1x1"]))


def _migrate_v4_key(key: str) -> Optional[str]:
    """v4 keys predate the precision/pipeline dimensions — every tuning was
    the f32 lane with automatic (implicit) pipelining, so they land in the
    ``f32/0`` slot of the v5 key space (then through v5->v6); integer-lane
    and manual-depth tunings can never collide with them."""
    parts = key.split("/")
    if len(parts) != 9:
        return None
    return _migrate_v5_key("/".join(parts + ["f32", "0"]))


def _migrate_v5_key(key: str) -> Optional[str]:
    """v5 keys predate the stencil-plan dimension — every tuning was a
    plain single-operator kernel, so they land in the ``-`` plan slot of
    the v6 key space; fused-plan tunings can never collide with them."""
    parts = key.split("/")
    if len(parts) != 11:
        return None
    return "/".join(parts + ["-"])


class TuningCache:
    """JSON-backed best-known-config store.

    Schema: ``{key: {"block_h": int, "block_w": int, "depth": int,
    "us": float}}`` with a ``__meta__`` entry recording the schema version
    (``depth`` is the tuned pipeline depth, 0 = automatic; absent reads as
    0). Older files (v1: no padding/layout key segments; v2: size segment
    instead of operator name; v3: no device-count/mesh segments; v4: no
    precision/pipeline-depth segments; v5: no plan segment) are migrated
    in-memory on load and rewritten as v6 on the next :meth:`save`.
    """

    VERSION = 6

    def __init__(self, path: Optional[str] = None):
        self.path = path or default_cache_path()
        self._entries: Dict[str, Dict] = {}
        self.load()

    @staticmethod
    def _valid_entry(value) -> bool:
        """A usable cache entry: a dict with positive-int-able block dims."""
        if not isinstance(value, dict):
            return False
        try:
            return int(value["block_h"]) > 0 and int(value["block_w"]) > 0
        except (KeyError, TypeError, ValueError):
            return False

    def load(self) -> "TuningCache":
        """Load (and migrate) the cache file; never raises.

        A tuning cache is an optional accelerant, so a bad file must not
        take ``edge_detect`` down: unreadable/truncated JSON, a non-dict
        payload, an unknown *future* schema version (a newer deployment's
        file on a shared path), and individually corrupted entries are all
        skipped with a warning rather than raised.
        """
        self._entries = {}
        try:
            with open(self.path) as f:
                raw = json.load(f)
        except FileNotFoundError:
            return self
        except (json.JSONDecodeError, OSError, UnicodeDecodeError) as e:
            warnings.warn(
                f"ignoring unreadable tuning cache {self.path}: {e}",
                RuntimeWarning, stacklevel=2,
            )
            return self
        if not isinstance(raw, dict):
            warnings.warn(
                f"ignoring tuning cache {self.path}: expected a JSON object, "
                f"got {type(raw).__name__}",
                RuntimeWarning, stacklevel=2,
            )
            return self
        meta = raw.get("__meta__")
        version = meta.get("version", 1) if isinstance(meta, dict) else 1
        if not isinstance(version, int) or version > self.VERSION:
            # A future schema's key layout is unknowable here — dropping the
            # entries (tunings re-measure on demand) beats misreading them.
            warnings.warn(
                f"ignoring tuning cache {self.path}: schema version "
                f"{version!r} is newer than supported ({self.VERSION}); "
                "run with a matching build or delete the file",
                RuntimeWarning, stacklevel=2,
            )
            return self
        entries = {k: v for k, v in raw.items() if not k.startswith("__")}
        if version < self.VERSION:
            migrate = {
                1: _migrate_v1_key,
                2: _migrate_v2_key,
                3: _migrate_v3_key,
                4: _migrate_v4_key,
            }.get(version, _migrate_v5_key)
            migrated = {}
            for k, v in entries.items():
                mk = migrate(k)
                if mk is not None:
                    migrated[mk] = v
            entries = migrated
        bad = [k for k, v in entries.items() if not self._valid_entry(v)]
        if bad:
            warnings.warn(
                f"skipping {len(bad)} corrupted tuning cache entr"
                f"{'y' if len(bad) == 1 else 'ies'} in {self.path} "
                f"(e.g. {bad[0]!r})",
                RuntimeWarning, stacklevel=2,
            )
        self._entries = {k: v for k, v in entries.items() if k not in set(bad)}
        return self

    def save(self) -> None:
        """Atomically persist the cache, merging concurrent writers.

        The write itself was always torn-file-proof (write-temp +
        ``os.replace``), but two serving processes doing read-modify-write
        could still lose each other's tunings — last replace wins. Under an
        advisory lock on a ``.lock`` sidecar (``flock`` binds to the open
        file description, so concurrent threads serialize too), the saver
        re-reads the file and merges entry-by-entry: a key present on both
        sides keeps the *faster* measured tuning, so the cache only ever
        improves regardless of writer interleaving. The merge result also
        replaces the in-memory view, so a saver sees its peers' entries.
        """
        os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
        with _file_lock(f"{self.path}.lock"):
            on_disk = dict(TuningCache(self.path)._entries)
            for k, v in self._entries.items():
                cur = on_disk.get(k)
                if cur is None or not self._valid_entry(cur) or (
                    float(v.get("us", float("inf")))
                    <= float(cur.get("us", float("inf")))
                ):
                    on_disk[k] = v
            self._entries = on_disk
            payload = {"__meta__": {"version": self.VERSION}}
            payload.update(dict(sorted(self._entries.items())))
            tmp = f"{self.path}.tmp.{os.getpid()}.{id(self)}"
            with open(tmp, "w") as f:
                json.dump(payload, f, indent=2)
                f.write("\n")
            os.replace(tmp, self.path)

    def lookup(self, key: TuneKey) -> Optional[Tuple[int, int, int]]:
        """(block_h, block_w, depth) for the key, or None. ``depth`` is the
        tuned pipeline depth (0 = automatic; pre-v5 entries read as 0)."""
        e = self._entries.get(key.to_str())
        if not e:
            return None
        if not self._valid_entry(e):  # belt-and-braces: entries set post-load
            warnings.warn(
                f"skipping corrupted tuning cache entry {key.to_str()!r} "
                f"in {self.path}",
                RuntimeWarning, stacklevel=2,
            )
            return None
        try:
            depth = int(e.get("depth", 0))
        except (TypeError, ValueError):
            depth = 0
        return int(e["block_h"]), int(e["block_w"]), depth

    def record(
        self, key: TuneKey, block_h: int, block_w: int, us: float,
        depth: int = 0,
    ) -> None:
        self._entries[key.to_str()] = {
            "block_h": int(block_h),
            "block_w": int(block_w),
            "depth": int(depth),
            "us": float(us),
        }

    def __len__(self) -> int:
        return len(self._entries)


def default_cache_path() -> str:
    env = os.environ.get("REPRO_TUNE_CACHE")
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "repro_torch", "sobel_blocks.json")


_DEFAULT_CACHE: Optional[TuningCache] = None


def get_default_cache() -> TuningCache:
    """Process-wide cache singleton (lazily loaded from disk)."""
    global _DEFAULT_CACHE
    if _DEFAULT_CACHE is None or _DEFAULT_CACHE.path != default_cache_path():
        _DEFAULT_CACHE = TuningCache()
    return _DEFAULT_CACHE


# ---------------------------------------------------------------------------
# Timing harness
# ---------------------------------------------------------------------------

def _sync(out) -> None:
    """Wait for the card when ``out`` (a tensor or a tuple of them) lies on it."""
    first = out[0] if isinstance(out, tuple) else out
    if isinstance(first, torch.Tensor) and first.device.type == "cuda":
        torch.cuda.synchronize(first.device)


def measure_us(fn, *args, iters: int = 3, warmup: int = 1) -> float:
    """Best-of-``iters`` wall time per call in microseconds, after
    ``warmup`` calls (the first builds and loads the kernel). Best-of, not
    mean: scheduler and clock jitter only ever add time. A call on the card
    ends in ``torch.cuda.synchronize()``, so the time is the device's, not
    the enqueue's. ``$REPRO_BENCH_ITERS`` raises ``iters`` on noisy hosts."""
    iters = max(iters, int(os.environ.get("REPRO_BENCH_ITERS", "0") or 0))
    out = None
    for _ in range(max(1, warmup)):
        out = fn(*args)
    _sync(out)
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn(*args)
        _sync(out)
        best = min(best, time.perf_counter() - t0)
    return best * 1e6


# ---------------------------------------------------------------------------
# Shape enumeration + sweep
# ---------------------------------------------------------------------------

def _spec(operator: Optional[str], size: int):
    from repro_torch.core.filters import get_operator, operator_for_size

    return get_operator(operator or operator_for_size(size))


def tile_smem_bytes(bh: int, bw: int, spec, *, depth: int = 0, layout: str = "gray",
                    dtype: str = "float32", nms: bool = False, plan=None) -> int:
    """Shared memory one CTA reserves for the tile: K1's halo window (and
    NMS buffers) at depth 0, K2's ring, offsets and window (one wider with
    NMS) at depths 2..8, whatever the variant, directions and lane (the
    integer lane's window is 4 bytes an element too). A ``plan`` with
    pre-stages widens the window to its composed reach and adds the
    pre-stage plane."""
    if not depth:
        return window_smem_bytes(bh, bw, spec.radius, nms, plan=plan)
    return pipelined_smem_bytes(bh, bw, spec.radius, depth, np.dtype(dtype).itemsize,
                                3 if layout == "rgb" else 1, nms, plan=plan)


def tile_fits(bh: int, bw: int, spec, *, depth: int = 0, layout: str = "gray",
              dtype: str = "float32", plan=None) -> bool:
    """Whether a tuned ``(bh, bw, depth)`` can serve every call that looks
    it up: the key carries no ``nms``, and the stream path takes the tile
    of the depth-0 slot for K3, so the tile must fit with NMS on at its
    depth and in K1/K3's NMS window (with ``plan``, its composed window
    and plane)."""
    kw = dict(layout=layout, dtype=dtype, nms=True, plan=plan)
    return (tile_smem_bytes(bh, bw, spec, **kw) <= SMEM_MAX
            and tile_smem_bytes(bh, bw, spec, depth=depth, **kw) <= SMEM_MAX)


def _check_backend(backend: str, *, timed: bool = True) -> None:
    """``cuda`` times the kernels and needs the card; ``torch`` times the
    plain versions on the CPU, only when asked for. ``timed=False`` checks
    the name alone."""
    if backend not in ("cuda", "torch"):
        raise ValueError(f"unknown tuning backend {backend!r}; expected 'cuda' or 'torch'")
    if timed and backend == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tuning backend='cuda' times the CUDA kernels and no CUDA device is "
            "available; pass backend='torch' to time the plain versions on the CPU"
        )


def legal_block_shapes(
    h: int,
    w: int,
    *,
    size: int = 5,
    operator: Optional[str] = None,
    backend: str = "cuda",
    layout: str = "gray",
    dtype: str = "float32",
    depth: int = 0,
    plan=None,
) -> List[Tuple[int, int]]:
    """All ``(block_h, block_w)`` candidates legal for an ``h x w`` image at
    ring depth ``depth`` (0 = K1).

    The kernels take any tile (ragged edges are masked), so legality is:
    not wastefully larger than the image (keep only the smallest candidate
    past twice its size), :func:`tile_fits` (the NMS footprints within
    ``SMEM_MAX``), and on the ``cuda`` backend a width that is a multiple
    of the 32-thread warp. ``operator`` (registry name) overrides ``size``;
    ``plan`` overrides both, and its composed window and plane must fit.
    """
    _check_backend(backend, timed=False)
    spec = plan.gradient if plan is not None else _spec(operator, size)
    shapes = []
    for bh in _CAND_H:
        for bw in _CAND_W:
            if backend == "cuda" and bw % 32:
                continue
            if (bh >= 2 * h and bh != _CAND_H[0]) or (bw >= 2 * w and bw != _CAND_W[0]):
                continue
            if not tile_fits(bh, bw, spec, depth=depth, layout=layout, dtype=dtype, plan=plan):
                continue
            shapes.append((bh, bw))
    return shapes


def _run_shape(img, spec, variant, directions, padding, backend, bh, bw, precision="f32",
               depth=0, plan=None):
    from repro_torch.kernels.edge import edge_cuda, edge_plain

    run = edge_cuda if backend == "cuda" else edge_plain
    return run(img, spec=spec, variant=variant, directions=directions, padding=padding,
               block_h=bh, block_w=bw, rgb=img.ndim == 4, precision=precision,
               pipeline_depth=depth, plan=plan,
               out_nms=plan.nms if plan is not None else False)


def _timed_spec(plan, operator, size, what: str):
    """``(plan, spec)``: the resolved plan (or None) and the operator it
    times, its gradient stage."""
    from repro_torch.core.filters import resolve_plan

    plan = resolve_plan(plan)
    if plan is None:
        return None, _spec(operator, size)
    if plan.gradient is None:
        raise ValueError(
            f"plan {plan.name!r} has no gradient stage; the edge kernel {what} needs one"
        )
    return plan, plan.gradient


def sweep(
    h: int,
    w: int,
    *,
    size: int = 5,
    operator: Optional[str] = None,
    variant: str = "v2",
    directions: int = 0,   # 0 = operator max
    dtype: str = "float32",
    backend: str = "cuda",
    padding: str = "reflect",
    layout: str = "gray",
    shapes: Optional[Sequence[Tuple[int, int]]] = None,
    iters: int = 3,
    seed: int = 0,
    precision: str = "f32",
    depths: Sequence[int] = (0,),
    batch: int = 1,
    plan=None,
) -> List[Dict]:
    """Time every candidate tile at every depth on a random ``(batch, h, w)``
    frame (``(batch, h, w, 3)`` for ``layout="rgb"``) made from ``seed``.

    Returns one row per (shape, depth) that :func:`tile_fits`:
    ``{"block_h", "block_w", "depth", "us", "smem_bytes", "halo_overhead",
    "grid_steps"}``, ``smem_bytes`` being the footprint of the magnitude
    lane it timed. The ``cuda`` backend (the default) times the kernels on
    the card and raises where there is none; ``torch`` times their plain
    versions on the CPU. ``precision="int"`` times the integer lane; pass
    ``dtype="uint8"`` with it. ``plan`` (a stencil plan or a registered
    name) overrides ``operator``/``size`` and times the fused plan, with
    NMS when the plan ends in it.
    """
    _check_backend(backend)
    plan, spec = _timed_spec(plan, operator, size, "sweep")
    variant = spec.resolve_variant(variant)
    directions = spec.resolve_directions(directions)
    device = torch.device("cuda" if backend == "cuda" else "cpu")
    rng = np.random.default_rng(seed)
    shape = (batch, h, w, 3) if layout == "rgb" else (batch, h, w)
    img = torch.from_numpy(rng.integers(0, 256, shape).astype(dtype)).to(device)
    rows = []
    for depth in depths:
        cands = shapes if shapes is not None else legal_block_shapes(
            h, w, operator=spec.name, backend=backend, layout=layout, dtype=dtype, depth=depth,
            plan=plan)
        for bh, bw in cands:
            if not tile_fits(bh, bw, spec, depth=depth, layout=layout, dtype=dtype, plan=plan):
                continue  # this depth's ring and NMS halo do not fit beside this tile
            smem = tile_smem_bytes(bh, bw, spec, depth=depth, layout=layout, dtype=dtype,
                                   nms=plan is not None and plan.nms, plan=plan)
            us = measure_us(_run_shape, img, spec, variant, directions, padding, backend,
                            bh, bw, precision, depth, plan, iters=iters)
            rows.append({
                "block_h": bh,
                "block_w": bw,
                "depth": depth,
                "us": us,
                "smem_bytes": smem,
                "halo_overhead": halo_amplification(
                    bh, bw, plan.reach if plan is not None else spec.radius),
                "grid_steps": -(-h // bh) * -(-w // bw),
            })
    return rows


def autotune(
    h: int,
    w: int,
    *,
    size: int = 5,
    operator: Optional[str] = None,
    variant: str = "v2",
    directions: int = 0,   # 0 = operator max
    dtype: str = "float32",
    backend: str = "cuda",
    padding: str = "reflect",
    layout: str = "gray",
    shapes: Optional[Sequence[Tuple[int, int]]] = None,
    iters: int = 3,
    cache: Optional[TuningCache] = None,
    refresh: bool = False,
    save: bool = True,
    precision: str = "f32",
    pipeline_depth: Optional[int] = None,
    batch: int = 1,
    plan=None,
) -> Tuple[int, int, int]:
    """Best ``(block_h, block_w, depth)`` for the workload; cached across
    processes.

    Consults ``cache`` (default: the process-wide JSON cache) unless
    ``refresh``; on a miss, sweeps the legal shapes, records the winner and
    saves the cache (``save=False`` to skip). ``precision`` keys and times
    the resolved lane. ``pipeline_depth=None`` lets the sweep choose between
    K1 (depth 0) and a depth-2 ring, recording the faster; an explicit
    depth pins the sweep and the cache slot to it. ``batch`` frames are
    timed per call (the cache key does not hold it). ``backend="cuda"``
    (the default) tunes the kernels and raises where there is no card;
    ``backend="torch"`` tunes the plain versions on the CPU. ``plan`` (a
    stencil plan or a registered name) overrides ``operator``/``size``: the
    sweep times the fused plan and the winner lands in the plan's slot,
    ``filters.plan_identity(plan)``.
    """
    from repro_torch.core.filters import plan_identity

    _check_backend(backend)
    plan, spec = _timed_spec(plan, operator, size, "autotune")
    # Key on the resolved variant, so the slot matches what ran.
    variant = spec.resolve_variant(variant)
    cache = cache if cache is not None else get_default_cache()
    key = TuneKey(backend, dtype, spec.name, variant, h, w, padding, layout,
                  1, "1x1x1", precision, pipeline_depth or 0,
                  plan_identity(plan) if plan is not None else "-")
    if not refresh:
        hit = cache.lookup(key)
        if hit is not None:
            return hit
    depths = (0, 2) if pipeline_depth is None else (pipeline_depth,)
    rows = sweep(
        h, w, operator=spec.name, variant=variant, directions=directions, dtype=dtype,
        backend=backend, padding=padding, layout=layout, shapes=shapes, iters=iters,
        precision=precision, depths=depths, batch=batch, plan=plan,
    )
    if not rows:
        raise ValueError(f"no legal block shapes for {key.to_str()}")
    best = min(rows, key=lambda r: r["us"])
    cache.record(key, best["block_h"], best["block_w"], best["us"], best["depth"])
    if save:
        cache.save()
    return best["block_h"], best["block_w"], best["depth"]
