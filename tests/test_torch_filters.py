"""The port's operator registry carries the reference's operators exactly.

Each reference ``OperatorSpec`` is handed over as numpy arrays through
``repro_torch.core.filters.carry_operator`` and must equal the port's own
registry entry: taps, separable and v2 factors, radius, and how requests
for every variant and direction count resolve.
"""
import importlib

import numpy as np
import pytest

from repro.core import filters as RF
from repro_torch.core import filters as TF

RS = importlib.import_module("repro.core.sobel")
TS = importlib.import_module("repro_torch.core.sobel")

BUILTINS = ("sobel5", "sobel3", "scharr3", "prewitt3", "sobel7")


def _carry(ref_spec):
    return TF.carry_operator(
        ref_spec.name,
        size=ref_spec.size,
        directions=ref_spec.directions,
        variants=ref_spec.variants,
        taps=np.asarray(ref_spec.taps, np.float32),
        sep=[ref_spec.sep_factors(d) for d in range(len(ref_spec.sep))],
        v2_factors=ref_spec.v2_arrays() if ref_spec.v2_factors is not None else None,
    )


def _assert_same_operator(ref_spec, port_spec):
    assert port_spec.name == ref_spec.name
    assert port_spec.size == ref_spec.size
    assert port_spec.radius == ref_spec.radius
    assert port_spec.directions == ref_spec.directions
    assert port_spec.variants == ref_spec.variants
    np.testing.assert_array_equal(port_spec.bank(), ref_spec.bank())
    for d in range(len(ref_spec.sep)):
        for a, b in zip(port_spec.sep_factors(d), ref_spec.sep_factors(d)):
            np.testing.assert_array_equal(a, b)
    if 4 in ref_spec.directions:
        np.testing.assert_array_equal(port_spec.kd_plus_dense(), ref_spec.kd_plus_dense())
        np.testing.assert_array_equal(port_spec.kd_minus_dense(), ref_spec.kd_minus_dense())
    if ref_spec.v2_factors is not None:
        for a, b in zip(port_spec.v2_arrays(), ref_spec.v2_arrays()):
            np.testing.assert_array_equal(a, b)
    for v in (None, "auto", "direct", "separable", "v1", "v2"):
        assert port_spec.resolve_variant(v) == ref_spec.resolve_variant(v)
    for d in (0, None) + tuple(ref_spec.directions):
        assert port_spec.resolve_directions(d) == ref_spec.resolve_directions(d)


@pytest.mark.parametrize("name", BUILTINS)
def test_builtin_operator_carries_across(name):
    ref_spec = RF.get_operator(name)
    carried = _carry(ref_spec)
    assert carried == TF.get_operator(name)
    _assert_same_operator(ref_spec, carried)


def test_registries_list_the_same_builtins():
    assert set(BUILTINS) <= set(TF.list_operators())
    assert set(BUILTINS) <= set(RF.list_operators())
    for size in (3, 5, 7):
        assert TF.operator_for_size(size) == RF.operator_for_size(size)


def test_factor_builders_match():
    p_ref = RF.SobelParams(a=2.0, b=3.0, m=5.0, n=7.0)
    p = TF.SobelParams(a=2.0, b=3.0, m=5.0, n=7.0)
    for fn in ("kx", "ky", "kd", "kdt", "kd_plus", "kd_minus", "filter_bank_5x5"):
        np.testing.assert_array_equal(getattr(TF, fn)(p), getattr(RF, fn)(p_ref))
    for fn in ("kx_factors", "ky_factors", "kd_plus_rows"):
        for a, b in zip(getattr(TF, fn)(p), getattr(RF, fn)(p_ref)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    (cf, rf), (cd, rd) = TF.kd_minus_factors(p)
    (cf_r, rf_r), (cd_r, rd_r) = RF.kd_minus_factors(p_ref)
    for a, b in ((cf, cf_r), (rf, rf_r), (cd, cd_r), (rd, rd_r)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(TF.filter_bank_3x3(4), RF.filter_bank_3x3(4))


def test_custom_separable_operator_carries_across():
    col, row = (1.0, 3.0, 5.0, 3.0, 1.0), (-2.0, -1.0, 0.0, 1.0, 2.0)
    RF.register_operator("carry_custom5", RF.make_separable_spec("carry_custom5", col, row),
                         overwrite=True)
    TF.register_operator("carry_custom5", TF.make_separable_spec("carry_custom5", col, row),
                         overwrite=True)
    ref_spec = RF.get_operator("carry_custom5")
    assert _carry(ref_spec) == TF.get_operator("carry_custom5")

    img = np.random.default_rng(3).uniform(0, 255, (2, 11, 13)).astype(np.float32)
    g_ref = np.asarray(RS.sobel(img, operator="carry_custom5", variant="separable"))
    g = TS.sobel(img, operator="carry_custom5", variant="separable").numpy()
    np.testing.assert_array_equal(g, g_ref)


def test_custom_sobel_params_carry_across():
    ref_spec = RF.get_operator("sobel5", RF.SobelParams(a=2.0, b=3.0, m=5.0, n=7.0))
    port_spec = TF.get_operator("sobel5", TF.SobelParams(a=2.0, b=3.0, m=5.0, n=7.0))
    assert _carry(ref_spec) == port_spec
    _assert_same_operator(ref_spec, port_spec)


def test_carry_rejects_inconsistent_factors():
    ref_spec = RF.get_operator("sobel3")
    taps = np.asarray(ref_spec.taps, np.float32).copy()
    taps[0, 0, 0] += 1.0
    with pytest.raises(ValueError, match="reconstruct"):
        TF.carry_operator(
            "broken", size=3, directions=(2, 4), variants=("direct", "separable"),
            taps=taps, sep=[ref_spec.sep_factors(0), ref_spec.sep_factors(1)],
        )


def test_unknown_variant_and_directions_raise_like_the_reference():
    spec = TF.get_operator("sobel3")
    with pytest.raises(ValueError, match="unknown variant"):
        spec.resolve_variant("v3")
    with pytest.raises(ValueError, match="supports directions"):
        TF.get_operator("scharr3").resolve_directions(4)
    with pytest.raises(KeyError):
        TF.get_operator("nope")
