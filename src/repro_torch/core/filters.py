"""Multi-directional edge filters and the declarative operator registry.

``repro.core.filters`` without JAX: the operator registry and the
stencil-plan layer. Paper §3.1–§3.2
(Eqs. 3, 5, 10, 18): the 5x5 filters are parameterized by
``SobelParams(a, b, m, n)``; the paper's (and OpenCV's) weights are
``a=1, b=2, m=6, n=4``.

Filters are applied as *correlation* (OpenCV ``filter2D`` semantics):
``G[y, x] = sum_{i,j} K[i, j] * I[y+i-r, x+j-r]``.

Every operator is one :class:`OperatorSpec`: a frozen, hashable declaration
of its dense taps, separable factors, supported direction counts and (for
the Sobel 5x5 family) the K_d± data behind the RG-v1/RG-v2 variants. The
taps are to this system what weights are to a model: :func:`carry_operator`
builds a spec from another implementation's arrays, so both packages can be
shown to run the same operator.

A :class:`StencilPlan` chains single-plane pre-stages (smoothing,
morphology, pointwise maps) ahead of one gradient operator and an optional
NMS stage; its composed reach is the one halo every layer below derives
from, so ``canny5`` (Gaussian5 -> sobel5 -> NMS) runs as one kernel launch
with a 2 + 2 + 1 pixel halo. :func:`carry_plan` builds a plan from another
implementation's stage fields and operator arrays.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "SobelParams",
    "OperatorSpec",
    "register_operator",
    "get_operator",
    "list_operators",
    "operator_for_size",
    "make_separable_spec",
    "carry_operator",
    "kx",
    "ky",
    "kd",
    "kdt",
    "kd_plus",
    "kd_minus",
    "kx_factors",
    "ky_factors",
    "kd_plus_rows",
    "kd_minus_factors",
    "filter_bank_5x5",
    "filter_bank_3x3",
    "SOBEL3_GX",
    "SOBEL3_GY",
    "SOBEL3_GD",
    "SOBEL3_GDT",
    "Stage",
    "StencilPlan",
    "linear_stage",
    "pointwise_stage",
    "window_stage",
    "plan_identity",
    "register_pointwise",
    "get_pointwise",
    "register_stage",
    "get_stage",
    "list_stages",
    "make_plan",
    "register_plan",
    "get_plan",
    "list_plans",
    "resolve_plan",
    "carry_plan",
]

LADDER = ("direct", "separable", "v1", "v2")


@dataclasses.dataclass(frozen=True)
class SobelParams:
    """Generalized 5x5 Sobel weights (paper Eq. 5). Defaults = OpenCV weights."""

    a: float = 1.0
    b: float = 2.0
    m: float = 6.0
    n: float = 4.0

    def as_tuple(self) -> Tuple[float, float, float, float]:
        return (self.a, self.b, self.m, self.n)


def _arr(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


# ---------------------------------------------------------------------------
# Separable factors
# ---------------------------------------------------------------------------

def kx_factors(p: SobelParams = SobelParams()):
    """K_x = a * col([1,n,m,n,1]) x row([-1,-b,0,b,1])  (Eq. 5)."""
    col = _arr([1.0, p.n, p.m, p.n, 1.0])
    row = _arr([-1.0, -p.b, 0.0, p.b, 1.0])
    return p.a, col, row


def ky_factors(p: SobelParams = SobelParams()):
    """K_y = a * col([-1,-b,0,b,1]) x row([1,n,m,n,1])  (Eq. 5)."""
    col = _arr([-1.0, -p.b, 0.0, p.b, 1.0])
    row = _arr([1.0, p.n, p.m, p.n, 1.0])
    return p.a, col, row


def kd_plus_rows(p: SobelParams = SobelParams()):
    """The two independent row vectors of K_d+ (Eq. 10/12), factor ``a`` included.

    K_d+ rows are ``[k0, k1, 0, -k1, -k0]`` (odd symmetry, Eq. 14).
    """
    a, b, m, n = p.as_tuple()
    k0 = _arr([-m, -(n + b), -2.0, -(n + b), -m]) * a
    k1 = _arr([b - n, -m * b, -2.0 * n * b, -m * b, b - n]) * a
    return k0, k1


def kd_minus_factors(p: SobelParams = SobelParams()):
    """Eq. 18: K_d- = a*(colF x rowF  -  colD x rowD).

    ``rowF`` is K_x's row vector, so RG-v2 reuses K_x's horizontal pass F;
    ``rowD = [0,-1,0,1,0]`` is the 2-tap difference D. Columns include ``a``.
    """
    a, b, m, n = p.as_tuple()
    col_f = _arr([m, n + b, 2.0, n + b, m]) * a
    row_f = _arr([-1.0, -b, 0.0, b, 1.0])
    col_d = _arr(
        [
            m * b + b - n,
            n * b + b * b - m * b,
            2.0 * b - 2.0 * n * b,
            n * b + b * b - m * b,
            m * b + b - n,
        ]
    ) * a
    row_d = _arr([0.0, -1.0, 0.0, 1.0, 0.0])
    return (col_f, row_f), (col_d, row_d)


# ---------------------------------------------------------------------------
# Dense filters
# ---------------------------------------------------------------------------

def kx(p: SobelParams = SobelParams()) -> np.ndarray:
    a, col, row = kx_factors(p)
    return a * np.outer(col, row)


def ky(p: SobelParams = SobelParams()) -> np.ndarray:
    a, col, row = ky_factors(p)
    return a * np.outer(col, row)


def kd(p: SobelParams = SobelParams()) -> np.ndarray:
    """45-degree filter (paper Eq. 5, third block)."""
    a, b, m, n = p.as_tuple()
    k = _arr(
        [
            [-m, -n, -1, -b, 0],
            [-n, -m * b, -n * b, 0, b],
            [-1, -n * b, 0, n * b, 1],
            [-b, 0, n * b, m * b, n],
            [0, b, 1, n, m],
        ]
    )
    return a * k


def kdt(p: SobelParams = SobelParams()) -> np.ndarray:
    """135-degree filter (paper Eq. 5, fourth block)."""
    a, b, m, n = p.as_tuple()
    k = _arr(
        [
            [0, -b, -1, -n, -m],
            [b, 0, -n * b, -m * b, -n],
            [1, n * b, 0, -n * b, -1],
            [n, m * b, n * b, 0, -b],
            [m, n, 1, b, 0],
        ]
    )
    return a * k


def kd_plus(p: SobelParams = SobelParams()) -> np.ndarray:
    """K_d+ = K_d + K_dt (Eq. 10)."""
    return kd(p) + kdt(p)


def kd_minus(p: SobelParams = SobelParams()) -> np.ndarray:
    """K_d- = K_d - K_dt (Eq. 10)."""
    return kd(p) - kdt(p)


def filter_bank_5x5(p: SobelParams = SobelParams()) -> np.ndarray:
    """(4, 5, 5) stack: [K_x, K_y, K_d, K_dt] — paper Eq. 3 when p is default."""
    return np.stack([kx(p), ky(p), kd(p), kdt(p)], axis=0)


SOBEL3_GX = _arr([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]])
SOBEL3_GY = _arr([[-1, -2, -1], [0, 0, 0], [1, 2, 1]])
# 45 / 135 degree 3x3 (Fig. 1(c)'s four-directional operator).
SOBEL3_GD = _arr([[-2, -1, 0], [-1, 0, 1], [0, 1, 2]])
SOBEL3_GDT = _arr([[0, -1, -2], [1, 0, -1], [2, 1, 0]])


def filter_bank_3x3(directions: int = 2) -> np.ndarray:
    """(D, 3, 3) stack of the classical 3x3 Sobel filters."""
    if directions == 2:
        return np.stack([SOBEL3_GX, SOBEL3_GY], axis=0)
    if directions == 4:
        return np.stack([SOBEL3_GX, SOBEL3_GY, SOBEL3_GD, SOBEL3_GDT], axis=0)
    raise ValueError(f"directions must be 2 or 4, got {directions}")


# ---------------------------------------------------------------------------
# Declarative operator registry
# ---------------------------------------------------------------------------

def _tupleize(a) -> tuple:
    """np array -> nested tuple of python floats (hashable, exact f32 values)."""
    a = np.asarray(a, np.float32)
    if a.ndim == 1:
        return tuple(float(v) for v in a)
    return tuple(_tupleize(row) for row in a)


@dataclasses.dataclass(frozen=True)
class OperatorSpec:
    """One edge operator, declaratively: everything the stack needs to run it.

    Array-valued fields are nested tuples of exact f32 values, so a spec is
    hashable.

    Fields:
      name:       registry key (``"sobel5"``, ``"scharr3"``, ...).
      size:       odd kernel side length (3 / 5 / 7 / ...).
      directions: supported direction counts, e.g. ``(2, 4)``.
      variants:   supported ladder variants in ladder order.
      taps:       ``(D_max, size, size)`` dense correlation taps in direction
                  order ``(K_x, K_y[, K_d, K_dt])``.
      sep:        per-direction ``(col, row)`` separable factors (or None);
                  ``K = col (x) row`` holds exactly (checked at registration).
      v2_factors: Eq. 18's split of K_d- as ``(col_f, col_d, row_d)``;
                  ``row_f`` is K_x's row vector. Present only with ``v2``.
    """

    name: str
    size: int
    directions: Tuple[int, ...]
    variants: Tuple[str, ...]
    taps: tuple
    sep: tuple
    v2_factors: Optional[tuple] = None

    def __post_init__(self):
        if self.size % 2 != 1 or self.size < 3:
            raise ValueError(f"operator size must be odd >= 3, got {self.size}")
        if len(self.taps) < max(self.directions):
            raise ValueError(
                f"{self.name}: {len(self.taps)} tap matrices for "
                f"directions={self.directions}"
            )
        for k in self.taps:
            if len(k) != self.size or any(len(r) != self.size for r in k):
                raise ValueError(f"{self.name}: taps are not {self.size}x{self.size}")

    @property
    def radius(self) -> int:
        return self.size // 2

    def bank(self, directions: Optional[int] = None) -> np.ndarray:
        """(D, size, size) dense f32 filter bank."""
        d = directions or max(self.directions)
        return np.asarray(self.taps[:d], np.float32)

    def sep_factors(self, direction: int) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """(col, row) f32 factors of direction ``direction``, or None."""
        if direction >= len(self.sep) or self.sep[direction] is None:
            return None
        col, row = self.sep[direction]
        return np.asarray(col, np.float32), np.asarray(row, np.float32)

    def kd_plus_dense(self) -> np.ndarray:
        """K_d+ = K_d + K_dt (Eq. 10)."""
        return self.bank(4)[2] + self.bank(4)[3]

    def kd_minus_dense(self) -> np.ndarray:
        """K_d- = K_d - K_dt (Eq. 10)."""
        return self.bank(4)[2] - self.bank(4)[3]

    def v2_arrays(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(col_f, col_d, row_d) f32 arrays of the Eq. 18 split."""
        if self.v2_factors is None:
            raise ValueError(f"operator {self.name!r} has no v2 factors")
        col_f, col_d, row_d = self.v2_factors
        return (
            np.asarray(col_f, np.float32),
            np.asarray(col_d, np.float32),
            np.asarray(row_d, np.float32),
        )

    def resolve_variant(self, variant: Optional[str]) -> str:
        """Map a requested ladder variant onto this operator.

        ``None``/``"auto"`` -> the operator's best (last) variant. A known
        ladder variant the operator doesn't implement falls back to the best
        supported one below it (3x3 has no diagonal transform: v2 ->
        separable). Unknown names raise.
        """
        if variant is None or variant == "auto":
            return self.variants[-1]
        if variant in self.variants:
            return variant
        if variant in LADDER:
            best = [v for v in self.variants if LADDER.index(v) <= LADDER.index(variant)]
            return best[-1] if best else self.variants[0]
        raise ValueError(f"unknown variant {variant!r}; expected one of {LADDER}")

    def resolve_directions(self, directions: Optional[int]) -> int:
        """``None``/``0`` -> the operator's max; otherwise validate."""
        if not directions:
            return max(self.directions)
        if directions not in self.directions:
            raise ValueError(
                f"operator {self.name!r} supports directions {self.directions}, "
                f"got {directions}"
            )
        return directions


def _check_sep_reconstructs(spec: OperatorSpec) -> None:
    """Separable factors must reconstruct the dense taps *exactly* (f32)."""
    for d in range(len(spec.taps)):
        fac = spec.sep_factors(d)
        if fac is None:
            continue
        col, row = fac
        dense = np.outer(col, row).astype(np.float32)
        if not np.array_equal(dense, spec.bank(d + 1)[d]):
            raise ValueError(
                f"{spec.name}: separable factors of direction {d} do not "
                "reconstruct the dense taps exactly"
            )


_OPERATOR_BUILDERS: Dict[str, Callable[[Optional[SobelParams]], OperatorSpec]] = {}


def register_operator(
    name: str,
    builder: "Callable[[Optional[SobelParams]], OperatorSpec] | OperatorSpec",
    *,
    overwrite: bool = False,
) -> None:
    """Register an operator under ``name``.

    ``builder`` is a constant :class:`OperatorSpec` or a callable
    ``params -> OperatorSpec``. The separable-factor/dense-tap consistency
    invariant is enforced here.
    """
    if name in _OPERATOR_BUILDERS and not overwrite:
        raise ValueError(f"operator {name!r} already registered")
    if isinstance(builder, OperatorSpec):
        spec = builder

        def builder(_params, _spec=spec):  # noqa: F811 — constant spec closure
            return _spec

    _check_sep_reconstructs(builder(None))
    _OPERATOR_BUILDERS[name] = builder
    get_operator.cache_clear()


@functools.lru_cache(maxsize=128)
def get_operator(name: str, params: Optional[SobelParams] = None) -> OperatorSpec:
    """Look up a registered operator (optionally with custom weights)."""
    if name not in _OPERATOR_BUILDERS:
        raise KeyError(
            f"unknown operator {name!r}; registered: {sorted(_OPERATOR_BUILDERS)}"
        )
    return _OPERATOR_BUILDERS[name](params)


def list_operators() -> Tuple[str, ...]:
    return tuple(sorted(_OPERATOR_BUILDERS))


def operator_for_size(size: int) -> str:
    """``size=3|5|7`` -> registry name."""
    names = {3: "sobel3", 5: "sobel5", 7: "sobel7"}
    if size not in names:
        raise ValueError(f"size must be one of {sorted(names)}, got {size}")
    return names[size]


def make_separable_spec(
    name: str,
    col: "np.ndarray | tuple",
    row: "np.ndarray | tuple",
) -> OperatorSpec:
    """A 2-direction spec from one separable derivative filter:
    ``K_x = col (x) row`` and ``K_y = K_x^T``."""
    col = np.asarray(col, np.float32)
    row = np.asarray(row, np.float32)
    if col.ndim != 1 or col.shape != row.shape:
        raise ValueError("col/row must be equal-length 1-D vectors")
    gx = np.outer(col, row).astype(np.float32)
    gy = gx.T.copy()
    return OperatorSpec(
        name=name,
        size=int(col.shape[0]),
        directions=(2,),
        variants=("direct", "separable"),
        taps=_tupleize(np.stack([gx, gy])),
        sep=((_tupleize(col), _tupleize(row)), (_tupleize(row), _tupleize(col))),
    )


def carry_operator(
    name: str,
    *,
    size: int,
    directions: Sequence[int],
    variants: Sequence[str],
    taps: np.ndarray,
    sep: Sequence,
    v2_factors: Optional[Sequence[np.ndarray]] = None,
) -> OperatorSpec:
    """Build this package's spec from another implementation's operator arrays.

    ``taps`` is the ``(D, size, size)`` dense bank, ``sep`` one ``(col, row)``
    pair (or None) per direction, ``v2_factors`` the ``(col_f, col_d,
    row_d)`` split or None. Values are taken as f32, exactly; the
    separable factors must reconstruct the taps.
    """
    spec = OperatorSpec(
        name=name,
        size=int(size),
        directions=tuple(int(d) for d in directions),
        variants=tuple(str(v) for v in variants),
        taps=_tupleize(taps),
        sep=tuple(
            None if s is None else (_tupleize(s[0]), _tupleize(s[1])) for s in sep
        ),
        v2_factors=(None if v2_factors is None
                    else tuple(_tupleize(f) for f in v2_factors)),
    )
    _check_sep_reconstructs(spec)
    return spec


# -- built-in specs ---------------------------------------------------------

def _sobel5_builder(params: Optional[SobelParams]) -> OperatorSpec:
    p = params or SobelParams()
    a, col_x, row_x = kx_factors(p)
    _, col_y, row_y = ky_factors(p)
    (col_f, _row_f), (col_d, row_d) = kd_minus_factors(p)
    return OperatorSpec(
        name="sobel5",
        size=5,
        directions=(2, 4),
        variants=("direct", "separable", "v1", "v2"),
        taps=_tupleize(filter_bank_5x5(p)),
        # a folded into the columns as ``a * col`` in numpy f32.
        sep=((_tupleize(a * col_x), _tupleize(row_x)),
             (_tupleize(a * col_y), _tupleize(row_y))),
        v2_factors=(_tupleize(col_f), _tupleize(col_d), _tupleize(row_d)),
    )


def _sobel3_builder(params: Optional[SobelParams]) -> OperatorSpec:
    # 3x3 has no SobelParams generalization; params are accepted and ignored.
    return OperatorSpec(
        name="sobel3",
        size=3,
        directions=(2, 4),
        variants=("direct", "separable"),
        taps=_tupleize(filter_bank_3x3(4)),
        sep=((_tupleize([1.0, 2.0, 1.0]), _tupleize([-1.0, 0.0, 1.0])),
             (_tupleize([-1.0, 0.0, 1.0]), _tupleize([1.0, 2.0, 1.0]))),
    )


# Extended 7x7 Sobel (Bogdan et al. 2019): binomial smoothing of order 6 x
# the order-7 Sobel derivative — OpenCV's getDerivKernels(1, 0, ksize=7).
_SOBEL7_SMOOTH = (1.0, 6.0, 15.0, 20.0, 15.0, 6.0, 1.0)
_SOBEL7_DERIV = (-1.0, -4.0, -5.0, 0.0, 5.0, 4.0, 1.0)

register_operator("sobel5", _sobel5_builder)
register_operator("sobel3", _sobel3_builder)
register_operator(
    "scharr3", make_separable_spec("scharr3", (3.0, 10.0, 3.0), (-1.0, 0.0, 1.0))
)
register_operator(
    "prewitt3", make_separable_spec("prewitt3", (1.0, 1.0, 1.0), (-1.0, 0.0, 1.0))
)
register_operator(
    "sobel7", make_separable_spec("sobel7", _SOBEL7_SMOOTH, _SOBEL7_DERIV)
)


# ---------------------------------------------------------------------------
# Stages and StencilPlans: the declarative multi-stage stencil layer
# ---------------------------------------------------------------------------
#
# A plan is an ordered, frozen sequence of stages; its reach (the sum of the
# stage radii, +1 for a trailing NMS stage) is the one halo number that
# kernels.tiling.window_radius and the fused kernels' windows derive from.
# Every rejection names its gate (`plan gate 'unknown-stage'`,
# `'frozen-stage'`, `'window-radius'`, `'nms-last'`, ...), in the reference's
# words, so tests and callers can pin the failing invariant.

_STAGE_KINDS = ("linear", "pointwise", "window_reduce", "nms")
_WINDOW_OPS = ("max", "min")


@dataclasses.dataclass(frozen=True)
class Stage:
    """One step of a :class:`StencilPlan`.

    Kinds:
      linear:        correlation with ``operator``'s taps. A single-direction
                     spec (``directions=(1,)``) is a smoothing pre-stage; a
                     multi-direction spec is the plan's gradient stage.
      pointwise:     shape-preserving map; ``op`` names a registered
                     pointwise fn (:func:`register_pointwise`). Radius 0.
      window_reduce: separable max/min over a ``(2r+1)``-square window
                     (dilate/erode); ``op`` in ``max | min``.
      nms:           non-maximum suppression (radius 1, last stage only).

    ``radius`` is the stage's halo; for a linear stage it must equal the
    operator's radius (use :func:`linear_stage`).
    """

    name: str
    kind: str
    operator: Optional[OperatorSpec] = None
    op: Optional[str] = None
    radius: int = 0

    def __post_init__(self):
        if self.kind not in _STAGE_KINDS:
            raise ValueError(
                f"plan gate 'stage-kind': stage {self.name!r} has unknown "
                f"kind {self.kind!r}; expected one of {_STAGE_KINDS}"
            )
        if self.kind == "linear":
            if self.operator is None:
                raise ValueError(
                    f"plan gate 'stage-kind': linear stage {self.name!r} "
                    "needs an OperatorSpec"
                )
            if self.radius != self.operator.radius:
                raise ValueError(
                    f"plan gate 'stage-radius': linear stage {self.name!r} "
                    f"declares radius {self.radius} but its operator has "
                    f"radius {self.operator.radius}"
                )
        elif self.kind == "pointwise":
            if self.radius != 0:
                raise ValueError(
                    f"plan gate 'stage-radius': pointwise stage "
                    f"{self.name!r} must have radius 0, got {self.radius}"
                )
            if self.op not in _POINTWISE_FNS:
                raise ValueError(
                    f"plan gate 'unknown-pointwise': stage {self.name!r} "
                    f"names pointwise fn {self.op!r}; registered: "
                    f"{sorted(_POINTWISE_FNS)}"
                )
        elif self.kind == "window_reduce":
            if self.op not in _WINDOW_OPS:
                raise ValueError(
                    f"plan gate 'window-op': window-reduce stage "
                    f"{self.name!r} needs op in {_WINDOW_OPS}, got {self.op!r}"
                )
            if self.radius < 1:
                raise ValueError(
                    f"plan gate 'window-radius': window-reduce stage "
                    f"{self.name!r} must have radius >= 1, got {self.radius} "
                    "(a zero-radius window reduces nothing)"
                )
        elif self.kind == "nms":
            if self.radius != 1:
                raise ValueError(
                    f"plan gate 'stage-radius': the NMS stage reaches "
                    f"exactly 1 pixel, got radius {self.radius}"
                )

    @property
    def single_plane(self) -> bool:
        """True when the stage maps one plane to one plane (a pre-stage)."""
        if self.kind == "linear":
            return max(self.operator.directions) == 1
        return self.kind in ("pointwise", "window_reduce")


def linear_stage(name: str, operator: OperatorSpec) -> Stage:
    return Stage(name=name, kind="linear", operator=operator, radius=operator.radius)


def pointwise_stage(name: str, fn: str) -> Stage:
    return Stage(name=name, kind="pointwise", op=fn, radius=0)


def window_stage(name: str, op: str, radius: int) -> Stage:
    return Stage(name=name, kind="window_reduce", op=op, radius=radius)


def _stage_is_frozen(stage) -> bool:
    params = getattr(type(stage), "__dataclass_params__", None)
    return params is not None and bool(params.frozen)


@dataclasses.dataclass(frozen=True)
class StencilPlan:
    """An ordered, frozen sequence of stages fused into one kernel launch.

    Zero or more single-plane pre-stages, then at most one multi-direction
    linear gradient stage, then optionally the NMS stage, which must be
    last. ``linear_reach`` is the sum of the non-NMS stage radii;
    ``reach`` adds NMS's +1. A plan is hashable, like an
    :class:`OperatorSpec`.
    """

    name: str
    stages: Tuple[Stage, ...]

    def __post_init__(self):
        if not self.stages:
            raise ValueError(f"plan gate 'empty-plan': plan {self.name!r} has no stages")
        for i, stage in enumerate(self.stages):
            if not _stage_is_frozen(stage):
                raise ValueError(
                    f"plan gate 'frozen-stage': stage "
                    f"{getattr(stage, 'name', stage)!r} of plan "
                    f"{self.name!r} is not a frozen dataclass — plans must "
                    "be hashable to cross jit boundaries"
                )
            if not isinstance(stage, Stage):
                raise ValueError(
                    f"plan gate 'stage-kind': plan {self.name!r} got a "
                    f"non-Stage entry {stage!r}"
                )
            if stage.kind == "nms" and i != len(self.stages) - 1:
                raise ValueError(
                    f"plan gate 'nms-last': plan {self.name!r} places the "
                    f"NMS stage at position {i}; NMS consumes the gradient "
                    "components and must be the last stage"
                )
        body = self.body
        for stage in body[:-1]:
            if not stage.single_plane:
                raise ValueError(
                    f"plan gate 'gradient-last': plan {self.name!r} places "
                    f"multi-direction stage {stage.name!r} before the end; "
                    "only the final non-NMS stage may produce direction "
                    "components"
                )
        if self.nms and (not body or body[-1].single_plane):
            raise ValueError(
                f"plan gate 'nms-gradient': plan {self.name!r} has an "
                "NMS stage but no multi-direction gradient stage to "
                "feed it"
            )

    @property
    def nms(self) -> bool:
        return self.stages[-1].kind == "nms"

    @property
    def body(self) -> Tuple[Stage, ...]:
        """All stages except a trailing NMS stage."""
        return self.stages[:-1] if self.nms else self.stages

    @property
    def gradient(self) -> Optional[OperatorSpec]:
        """The multi-direction operator of the final body stage, if any."""
        body = self.body
        if body and not body[-1].single_plane:
            return body[-1].operator
        return None

    @property
    def pre_stages(self) -> Tuple[Stage, ...]:
        """Single-plane stages ahead of the gradient (or the whole body)."""
        body = self.body
        return body[:-1] if self.gradient is not None else body

    @property
    def linear_reach(self) -> int:
        """Sum of the non-NMS stage radii: the composed correlation radius."""
        return sum(s.radius for s in self.body)

    @property
    def reach(self) -> int:
        """Total halo reach including NMS's +1 neighbourhood."""
        return self.linear_reach + (1 if self.nms else 0)

    @property
    def single_operator(self) -> bool:
        """True when the plan is exactly one gradient stage (+ maybe NMS):
        it then runs the single-operator path unchanged."""
        return not self.pre_stages and self.gradient is not None


def plan_identity(plan: StencilPlan) -> str:
    """Stable cache identity: the plan's name and a hash of its stage names,
    kinds and radii (the tuning key's plan segment). The reference's
    strings exactly, so a cache file keys the same plan in both packages."""
    sig = "|".join(f"{s.name}:{s.kind}:{s.radius}" for s in plan.stages)
    return f"{plan.name}.{hashlib.sha1(sig.encode()).hexdigest()[:8]}"


# -- pointwise registry -----------------------------------------------------

# name -> (fn, int_bound): ``fn`` is exact in both lanes (each op rounded on
# its own in f32, plain in integers); ``int_bound`` maps an input magnitude
# bound to the output's for the integer-lane proof, or None when the fn has
# no integer form.
_POINTWISE_FNS: Dict[str, tuple] = {}


def register_pointwise(name, fn, *, int_bound=None, overwrite: bool = False):
    if name in _POINTWISE_FNS and not overwrite:
        raise ValueError(f"pointwise fn {name!r} already registered")
    _POINTWISE_FNS[name] = (fn, int_bound)


def get_pointwise(name):
    if name not in _POINTWISE_FNS:
        raise ValueError(
            f"plan gate 'unknown-pointwise': unknown pointwise fn {name!r}; "
            f"registered: {sorted(_POINTWISE_FNS)}"
        )
    return _POINTWISE_FNS[name]


def _square_fenced(x: torch.Tensor) -> torch.Tensor:
    """``max(x * x, 0)``: the product rounded on its own, as the
    reference's fence against FMA contraction leaves it."""
    return torch.maximum(x * x, x.new_zeros(()))


register_pointwise("abs", torch.abs, int_bound=lambda m: m)
register_pointwise("square", _square_fenced, int_bound=lambda m: m * m)


# -- stage registry ---------------------------------------------------------

_STAGE_REGISTRY: Dict[str, Stage] = {}


def register_stage(name: str, stage: Stage, *, overwrite: bool = False) -> None:
    if name in _STAGE_REGISTRY and not overwrite:
        raise ValueError(f"stage {name!r} already registered")
    if stage.kind == "linear":
        _check_sep_reconstructs(stage.operator)
    _STAGE_REGISTRY[name] = stage


def _unknown_stage(ref) -> ValueError:
    return ValueError(
        f"plan gate 'unknown-stage': unknown stage {ref!r}; registered "
        f"stages: {sorted(_STAGE_REGISTRY)}; registered operators (usable "
        f"as gradient stages): {list_operators()}"
    )


def get_stage(name: str) -> Stage:
    if name not in _STAGE_REGISTRY:
        raise _unknown_stage(name)
    return _STAGE_REGISTRY[name]


def list_stages() -> Tuple[str, ...]:
    return tuple(sorted(_STAGE_REGISTRY))


def _gaussian_stage(name: str, g) -> Stage:
    """Separable binomial smoothing. The normalized taps are dyadic, so every
    tap and every outer-product entry is exact in f32."""
    g = np.asarray(g, np.float32)
    g = (g / np.float32(g.sum())).astype(np.float32)
    k = np.outer(g, g).astype(np.float32)
    spec = OperatorSpec(
        name=name,
        size=int(g.shape[0]),
        directions=(1,),
        variants=("direct", "separable"),
        taps=_tupleize(k[None]),
        sep=((_tupleize(g), _tupleize(g)),),
    )
    return linear_stage(name, spec)


register_stage("gaussian3", _gaussian_stage("gaussian3", (1.0, 2.0, 1.0)))
register_stage("gaussian5", _gaussian_stage("gaussian5", (1.0, 4.0, 6.0, 4.0, 1.0)))
register_stage("dilate3", window_stage("dilate3", "max", 1))
register_stage("erode3", window_stage("erode3", "min", 1))
register_stage("nms", Stage(name="nms", kind="nms", radius=1))


# -- plan registry ----------------------------------------------------------

def _resolve_stage_ref(ref):
    """A plan entry: a Stage, a registered stage name, a registered operator
    name (a gradient stage) or an OperatorSpec. Anything else is left to
    StencilPlan's 'frozen-stage' / 'stage-kind' gates."""
    if isinstance(ref, Stage):
        return ref
    if isinstance(ref, OperatorSpec):
        return linear_stage(ref.name, ref)
    if isinstance(ref, str):
        if ref in _STAGE_REGISTRY:
            return _STAGE_REGISTRY[ref]
        if ref in _OPERATOR_BUILDERS:
            return linear_stage(ref, get_operator(ref))
        raise _unknown_stage(ref)
    return ref


def make_plan(name: str, stages) -> StencilPlan:
    return StencilPlan(name=name, stages=tuple(_resolve_stage_ref(s) for s in stages))


_PLAN_REGISTRY: Dict[str, StencilPlan] = {}


def register_plan(name: str, stages, *, overwrite: bool = False) -> StencilPlan:
    if name in _PLAN_REGISTRY and not overwrite:
        raise ValueError(f"plan {name!r} already registered")
    plan = stages if isinstance(stages, StencilPlan) else make_plan(name, stages)
    _PLAN_REGISTRY[name] = plan
    return plan


def get_plan(name: str) -> StencilPlan:
    if name not in _PLAN_REGISTRY:
        raise ValueError(
            f"plan gate 'unknown-plan': unknown plan {name!r}; registered: "
            f"{sorted(_PLAN_REGISTRY)}"
        )
    return _PLAN_REGISTRY[name]


def list_plans() -> Tuple[str, ...]:
    return tuple(sorted(_PLAN_REGISTRY))


def resolve_plan(plan) -> Optional[StencilPlan]:
    """``None`` | plan name | StencilPlan -> StencilPlan or None."""
    if plan is None:
        return None
    if isinstance(plan, StencilPlan):
        return plan
    if isinstance(plan, str):
        return get_plan(plan)
    raise TypeError(
        f"plan must be a StencilPlan or a registered plan name, got "
        f"{type(plan).__name__}"
    )


def carry_plan(name: str, stages: Sequence[dict]) -> StencilPlan:
    """Build this package's plan from another implementation's stages.

    Each entry of ``stages`` holds one stage's fields: ``name``, ``kind``,
    ``radius``, ``op`` (or None) and ``operator``, None or the keyword
    arguments of :func:`carry_operator` (its ``name`` included). The plan's
    gates run as for any plan.
    """
    out = []
    for st in stages:
        op = st.get("operator")
        spec = None if op is None else carry_operator(**op)
        out.append(Stage(name=str(st["name"]), kind=str(st["kind"]), operator=spec,
                         op=st.get("op"), radius=int(st["radius"])))
    return StencilPlan(name=name, stages=tuple(out))


# The built-in plans: the Canny front half (blur -> 4-direction gradient ->
# NMS; hysteresis links the thin map afterwards) and its no-NMS sibling.
# canny5's reach is 2 + 2 + 1 = 5.
register_plan("canny5", ("gaussian5", "sobel5", "nms"))
register_plan("blur_sobel5", ("gaussian5", "sobel5"))
