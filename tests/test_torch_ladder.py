"""repro_torch.core.ladder against repro.core.ladder: the integer lane's
budgets, dtypes and eligibility (reasons included) for every registered
operator and for operators the lane must refuse."""
import numpy as np
import pytest
import torch

from repro.core import filters as RF
from repro.core import ladder as RL
from repro_torch.core import filters as TF
from repro_torch.core import ladder as TL

BUILTINS = ("sobel5", "sobel3", "scharr3", "prewitt3", "sobel7")

# Specs the lane must refuse, built (not registered) in both packages:
# fractional taps, and integer taps whose bound exceeds f32's exact range.
UNREGISTERED = {
    "binomial3": ((0.25, 0.5, 0.25), (-1.0, 0.0, 1.0)),
    "huge3": ((1.0, 4096.0, 1.0), (-4096.0, 0.0, 4096.0)),
}


def _specs(name):
    if name in UNREGISTERED:
        col, row = UNREGISTERED[name]
        return (TF.make_separable_spec(name, col, row), RF.make_separable_spec(name, col, row))
    return TF.get_operator(name), RF.get_operator(name)


OPERATORS = BUILTINS + tuple(UNREGISTERED)


def test_constants_match():
    assert TL.F32_EXACT_INT == RL.F32_EXACT_INT == 2**24


@pytest.mark.parametrize("name", OPERATORS)
def test_bounds_and_dtype_match_reference(name):
    port, ref = _specs(name)
    assert TL.tap_accumulation_bounds(port) == RL.tap_accumulation_bounds(ref)
    assert TL.tap_accumulation_bounds(port, input_max=1) == RL.tap_accumulation_bounds(
        ref, input_max=1)
    assert TL.accum_dtype(port) == RL.accum_dtype(ref)


def test_builtin_dtypes():
    """sobel5/sobel7 need i32 (worst bound 48,960 for sobel5); the 3x3
    operators fit i16."""
    got = {n: TL.accum_dtype(TF.get_operator(n)) for n in BUILTINS}
    assert got == {"sobel5": "int32", "sobel3": "int16", "scharr3": "int16",
                   "prewitt3": "int16", "sobel7": "int32"}
    assert TL.tap_accumulation_bounds(TF.get_operator("sobel5"))["worst"] == 48960.0


@pytest.mark.parametrize("name", OPERATORS)
@pytest.mark.parametrize("rgb", (False, True))
@pytest.mark.parametrize("dtype", (None, "uint8", "float32", "int16"))
def test_eligibility_matches_reference(name, rgb, dtype):
    port, ref = _specs(name)
    want = RL.int_lane_eligible(ref, rgb=rgb, input_dtype=dtype)
    assert TL.int_lane_eligible(port, rgb=rgb, input_dtype=dtype) == want
    if dtype is not None:  # torch dtypes name the same gate
        tdtype = getattr(torch, dtype)
        assert TL.int_lane_eligible(port, rgb=rgb, input_dtype=tdtype) == want
        assert TL.int_lane_eligible(port, rgb=rgb, input_dtype=np.dtype(dtype)) == want
