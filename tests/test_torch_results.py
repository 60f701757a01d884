"""The port's typed results (``adrates_torch.requests``) against the JAX
package's: the same objects built in both packages give the same
``to_dict``, JSON, DataFrame view, repr and sums, and both raise on the
same currency, curve, tenor and shape mismatches. The port imports
pandas only inside the DataFrame views (``test_torch_no_jax.py`` imports
every module with pandas blocked)."""

import importlib
import json

import numpy as np
import pandas as pd
import pytest

PKGS = ("adrates_tpu", "adrates_torch")
TENORS = ["1Y", "2Y", "5Y"]


def _ns(pkg):
    r = importlib.import_module(f"{pkg}.requests")
    u = importlib.import_module(f"{pkg}.utils")
    return r, u


def _objects(pkg) -> dict:
    """One of each result type, from the same numbers in either package."""
    r, u = _ns(pkg)
    C, Y, D = u.CurveTypes, u.CurrencyTypes, u.Date
    rng = np.random.default_rng(11)
    lad = rng.normal(size=3)
    g = rng.normal(size=(3, 3))
    g = g + g.T
    cube = rng.normal(size=(3, 3, 3))
    items = [r.CashflowItem(D(1, 7, 2024), 1e6, 0.04, 0.5, 20000.0, 0.98,
                            19600.0, "Fixed_Pay"),
             r.CashflowItem(D(1, 7, 2024), 1e6, 0.05, 0.5, 25000.0, 0.98,
                            24500.0, "Float_Rec"),
             r.CashflowItem(D(1, 7, 2029), 1e6, 1.0, 0.0, 1e6, 0.8, 8e5,
                            "Notional_Rec")]
    delta = r.Delta(lad, TENORS, Y.GBP, C.GBP_OIS_SONIA)
    gamma = r.Gamma(g, TENORS, Y.GBP, C.GBP_OIS_SONIA)
    cross = r.CrossGamma(rng.normal(size=(3, 2)), TENORS, ["1Y", "5Y"],
                         Y.GBP, C.GBP_OIS_SONIA, C.GBP_USD_BASIS)
    return dict(
        valuation=r.Valuation(1234.5, Y.USD),
        delta=delta,
        gamma=gamma,
        gamma_diag=r.Gamma(lad, TENORS, Y.GBP, C.GBP_OIS_SONIA),
        speed=r.Speed(cube, TENORS, Y.GBP, C.GBP_OIS_SONIA),
        cross=cross,
        cashflows=r.Cashflows(items, Y.GBP),
        ladder=delta.ladder,
        risk=r.Risk([delta, r.Delta(lad * 2, ["1Y", "2Y", "5Y"], Y.GBP,
                                    C.GBP_USD_BASIS)],
                    cross_gammas=[cross]),
        result=r.AnalyticsResult(value=r.Valuation(1.0, Y.GBP), risk=delta,
                                 gamma=gamma,
                                 cashflows=r.Cashflows(items, Y.GBP)))


@pytest.fixture(scope="module")
def objs():
    return {pkg: _objects(pkg) for pkg in PKGS}


WITH_DICT = ["valuation", "delta", "gamma", "gamma_diag", "speed", "cross",
             "cashflows", "ladder"]
WITH_DF = ["valuation", "delta", "gamma", "gamma_diag", "cross", "cashflows",
           "ladder"]


@pytest.mark.parametrize("name", WITH_DICT)
def test_to_dict_matches_jax(objs, name):
    assert objs["adrates_torch"][name].to_dict() == \
        objs["adrates_tpu"][name].to_dict()


@pytest.mark.parametrize("name", [n for n in WITH_DICT if n != "ladder"])
def test_to_json_matches_jax(objs, name):
    got = json.loads(objs["adrates_torch"][name].to_json())
    assert got == json.loads(objs["adrates_tpu"][name].to_json())


@pytest.mark.parametrize("name", WITH_DF)
def test_df_matches_jax(objs, name):
    got = objs["adrates_torch"][name].df
    assert isinstance(got, pd.DataFrame)
    pd.testing.assert_frame_equal(got, objs["adrates_tpu"][name].df)


@pytest.mark.parametrize("name", ["valuation", "delta", "gamma", "cross",
                                  "cashflows"])
def test_to_csv_matches_jax(objs, name):
    assert objs["adrates_torch"][name].to_csv() == \
        objs["adrates_tpu"][name].to_csv()


@pytest.mark.parametrize("name", ["valuation", "delta", "gamma", "speed",
                                  "cross", "cashflows", "ladder", "risk",
                                  "result"])
def test_repr_matches_jax(objs, name):
    assert repr(objs["adrates_torch"][name]) == \
        repr(objs["adrates_tpu"][name])


@pytest.mark.parametrize("name", ["valuation", "delta", "gamma", "speed"])
def test_add_matches_jax(objs, name):
    a, b = objs["adrates_torch"][name], objs["adrates_tpu"][name]
    assert (a + a).to_dict() == (b + b).to_dict()
    assert sum([a, a, a], a).to_dict() == sum([b, b, b], b).to_dict()


def _mismatch(pkg, case):
    """Two results of one type that must not add (or a bad subtraction)."""
    r, u = _ns(pkg)
    C, Y = u.CurveTypes, u.CurrencyTypes
    lad, g, cube = np.ones(3), np.eye(3), np.zeros((3, 3, 3))
    if case == "valuation_currency":
        return lambda: r.Valuation(1.0, Y.GBP) + r.Valuation(1.0, Y.USD)
    if case == "valuation_sub_currency":
        return lambda: r.Valuation(1.0, Y.GBP) - r.Valuation(1.0, Y.USD)
    base = dict(delta=(r.Delta, lad), gamma=(r.Gamma, g), speed=(r.Speed,
                                                                 cube))
    kind, what = case.split("_")
    cls, arr = base[kind]
    a = cls(arr, TENORS, Y.GBP, C.GBP_OIS_SONIA)
    if what == "curve":
        b = cls(arr, TENORS, Y.GBP, C.USD_OIS_SOFR)
    elif what == "currency":
        b = cls(arr, TENORS, Y.USD, C.GBP_OIS_SONIA)
    else:
        b = cls(arr, ["1Y", "3Y", "5Y"], Y.GBP, C.GBP_OIS_SONIA)
    return lambda: a + b


MISMATCH = ["valuation_currency", "valuation_sub_currency", "delta_curve",
            "delta_currency", "delta_tenors", "gamma_curve",
            "gamma_currency", "gamma_tenors", "speed_curve",
            "speed_tenors"]


@pytest.mark.parametrize("case", MISMATCH)
def test_add_mismatch_raises_as_jax(case):
    for pkg in PKGS:
        with pytest.raises(ValueError, match="Cannot"):
            _mismatch(pkg, case)()


def _bad_shape(pkg, case):
    r, u = _ns(pkg)
    C, Y = u.CurveTypes, u.CurrencyTypes
    return {
        "delta_length": lambda: r.Delta(np.ones(2), TENORS, Y.GBP,
                                        C.GBP_OIS_SONIA),
        "gamma_rows": lambda: r.Gamma(np.eye(2), TENORS, Y.GBP,
                                      C.GBP_OIS_SONIA),
        "speed_cube": lambda: r.Speed(np.zeros((3, 3, 2)), TENORS, Y.GBP,
                                      C.GBP_OIS_SONIA),
        "cross_shape": lambda: r.CrossGamma(np.zeros((2, 3)), ["1Y"],
                                            TENORS, Y.GBP, C.GBP_OIS_SONIA,
                                            C.GBP_USD_BASIS),
        "risk_duplicate": lambda: r.Risk(
            [r.Delta(np.ones(3), TENORS, Y.GBP, C.GBP_OIS_SONIA)] * 2),
    }[case]


@pytest.mark.parametrize("case", ["delta_length", "gamma_rows", "speed_cube",
                                  "cross_shape", "risk_duplicate"])
def test_bad_shape_raises_as_jax(case):
    for pkg in PKGS:
        with pytest.raises(ValueError):
            _bad_shape(pkg, case)()


def test_currency_type_checked():
    r, u = _ns("adrates_torch")
    with pytest.raises(TypeError):
        r.Valuation(1.0, "GBP")
    with pytest.raises(TypeError):
        r.Delta(np.ones(3), TENORS, "GBP", u.CurveTypes.GBP_OIS_SONIA)


def test_risk_access(objs):
    _, u = _ns("adrates_torch")
    C = u.CurveTypes
    o = objs["adrates_torch"]
    risk, delta = o["risk"], o["delta"]
    assert risk.GBP_OIS_SONIA is risk(C.GBP_OIS_SONIA)
    assert risk.has_cross_gamma(C.GBP_OIS_SONIA, C.GBP_USD_BASIS)
    assert risk.cross_gamma(C.USD_OIS_SOFR, C.GBP_USD_BASIS) is None
    assert list(risk.all_cross_gammas) == [("GBP_OIS_SONIA",
                                            "GBP_USD_BASIS")]
    with pytest.raises(ValueError, match="No risk data"):
        risk(C.USD_OIS_SOFR)
    assert delta(C.GBP_OIS_SONIA) is delta
    with pytest.raises(KeyError):
        delta(C.USD_OIS_SOFR)


def test_speed_slice_is_a_gamma(objs):
    s = objs["adrates_torch"]["speed"]
    sl = s.slice("2Y")
    np.testing.assert_array_equal(sl.risk_ladder, s.risk_cube[1])
    assert sl.tenors == TENORS
    assert sl.to_dict() == objs["adrates_tpu"]["speed"].slice(
        "2Y").to_dict()


def test_cashflow_filters_and_totals(objs):
    cfs, ref = objs["adrates_torch"]["cashflows"], \
        objs["adrates_tpu"]["cashflows"]
    for f in ("fixed", "floating", "pay", "receive", "notional_exchange"):
        assert len(getattr(cfs, f)) == len(getattr(ref, f)), f
        assert getattr(cfs, f).total_pv == getattr(ref, f).total_pv, f
    assert cfs.total_amount == ref.total_amount
    assert cfs.sum().amount == ref.sum().amount
    assert cfs.validate()
    assert cfs.aggregate(len) == 3
    assert [cf.leg_type for cf in cfs] == [cf.leg_type for cf in ref]


@pytest.mark.parametrize("check", ["no_nan", "no_inf", "shape", "square",
                                   "shape_match", "currency_match"])
def test_validators_raise_as_jax(check):
    for pkg in PKGS:
        V = importlib.import_module(f"{pkg}.requests.results_base") \
            .ValidationMixin
        Y = importlib.import_module(f"{pkg}.utils").CurrencyTypes
        call = {
            "no_nan": lambda: V.validate_no_nan([1.0, np.nan]),
            "no_inf": lambda: V.validate_no_inf([np.inf]),
            "shape": lambda: V.validate_shape(np.zeros((2, 2)), (2, 3)),
            "square": lambda: V.validate_square(np.zeros((2, 3))),
            "shape_match": lambda: V.validate_shape_match(np.zeros(2),
                                                          TENORS),
            "currency_match": lambda: V.validate_currency_match(Y.GBP,
                                                                Y.USD),
        }[check]
        with pytest.raises(ValueError):
            call()


def test_analytics_result_properties(objs):
    res = objs["adrates_torch"]["result"]
    assert res.value.amount == 1.0
    assert res.risk is objs["adrates_torch"]["result"].risk
    assert res.speed is None
    assert "cashflows=" in repr(res)
