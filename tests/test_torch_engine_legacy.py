"""The port's raw-input leg API (``Engine.build_curve_ad`` and
value/valuation/delta/gamma of the fixed and the float leg) against the
JAX package's, on the CPU, on the inputs of ``tests/test_engine_legacy.py``:
the same (swap_rates, swap_times, year_fracs) triples and legs built in
each package, compared at 1e-10 x max|ref|; plus the port's own FD and
par-netting checks of that file."""

import importlib

import numpy as np
import pytest

PKGS = ("adrates_tpu", "adrates_torch")
RATES = [0.052, 0.048, 0.0452, 0.0431]


def _ns(pkg):
    u = importlib.import_module(f"{pkg}.utils")
    rates = importlib.import_module(f"{pkg}.trades.rates")
    Engine = importlib.import_module(f"{pkg}.market.position.engine").Engine
    return u, rates, Engine


def _legs(pkg, coupon, years, notional=1e6):
    u, rates, _ = _ns(pkg)
    common = dict(freq_type=u.FrequencyTypes.ANNUAL,
                  dc_type=u.DayCountTypes.SIMPLE,
                  floating_index=u.CurveTypes.GBP_OIS_SONIA,
                  currency=u.CurrencyTypes.GBP, notional=notional,
                  cal_type=u.CalendarTypes.NONE)
    v = u.Date(1, 1, 2024)
    fixed = rates.SwapFixedLeg(v, f"{years}Y", u.SwapTypes.RECEIVE, coupon,
                               **common)
    flt = rates.SwapFloatLeg(v, f"{years}Y", u.SwapTypes.PAY, spread=0.0,
                             **common)
    return fixed, flt


# curve input swaps use the legs' own accrual fractions (knots exact)
_FR = [float(f) for f in _legs("adrates_torch", 0.0, 5)[0]._year_fracs]
FRACS = [_FR[:1], _FR[:2], _FR[:3], _FR[:5]]
TIMES = [sum(f) for f in FRACS]


def _xccy_curve(pkg):
    u, _, _ = _ns(pkg)
    Model = importlib.import_module(f"{pkg}.models").Model
    D, IT = u.DayCountTypes, u.InterpTypes
    m = Model(u.Date(1, 1, 2024))
    m.build_curve("USD_OIS_SOFR", px_list=[5.33, 5.05, 4.60, 4.00, 3.88],
                  tenor_list=["1M", "1Y", "2Y", "5Y", "10Y"],
                  fixed_dcc_type=D.ACT_360, float_dc_type=D.ACT_360,
                  interp_type=IT.FLAT_FWD_RATES)
    m.build_curve("GBP_OIS_SONIA", px_list=[5.19, 4.71, 4.35, 3.93, 3.87],
                  tenor_list=["1M", "1Y", "2Y", "5Y", "10Y"],
                  fixed_dcc_type=D.ACT_365F, float_dc_type=D.ACT_365F,
                  interp_type=IT.FLAT_FWD_RATES)
    m.build_xccy_curve(name="GBP_USD_BASIS",
                       domestic_curve_name="USD_OIS_SOFR",
                       foreign_curve_name="GBP_OIS_SONIA",
                       basis_spreads=[-2.0, -5.0, -8.0],
                       tenor_list=["1Y", "2Y", "5Y"], spot_fx=1.27)
    return m.curves["GBP_USD_BASIS"]


@pytest.fixture(scope="module")
def engines():
    out = {}
    for pkg in PKGS:
        _, _, Engine = _ns(pkg)
        kw = {} if pkg == "adrates_tpu" else dict(device="cpu")
        out[pkg] = dict(engine=Engine(model=None, **kw),
                        xccy=_xccy_curve(pkg))
    return out


# (leg, years, coupon, extra arguments of the float-leg calls)
CASES = {
    "fixed_2y": ("fixed", 2, 0.03, {}),
    "fixed_3y": ("fixed", 3, 0.048, {}),
    "fixed_5y": ("fixed", 5, 0.0431, {}),
    "float_3y": ("float", 3, 0.0, {}),
    "float_first_fixing": ("float", 2, 0.0, dict(first_fixing_rate=0.06)),
    "float_index_scheme": ("float", 3, 0.0,
                           dict(index_curve_type="LINEAR_ZERO_RATES")),
    "float_xccy_discount": ("float", 3, 0.0, dict(xccy=True)),
}


def _call(engines, pkg, case, measure):
    kind, years, cpn, extra = CASES[case]
    u, _, _ = _ns(pkg)
    eng = engines[pkg]["engine"]
    fixed, flt = _legs(pkg, cpn, years)
    v = u.Date(1, 1, 2024)
    it = u.InterpTypes.FLAT_FWD_RATES
    args = (RATES, TIMES, FRACS)
    if kind == "fixed":
        return getattr(eng, f"{measure}_fixed_leg")(*args, fixed, v, it)
    disc = engines[pkg]["xccy"] if extra.get("xccy") else it
    kw = {}
    if "first_fixing_rate" in extra:
        kw["first_fixing_rate"] = extra["first_fixing_rate"]
    if "index_curve_type" in extra:
        kw["index_curve_type"] = u.InterpTypes[extra["index_curve_type"]]
    return getattr(eng, f"{measure}_float_leg")(*args, flt, v, disc, **kw)


def _array(out):
    if hasattr(out, "risk_ladder"):
        return np.asarray(out.risk_ladder)
    if hasattr(out, "amount"):
        return np.array([out.amount])
    return np.atleast_1d(np.asarray(out.cpu() if hasattr(out, "cpu")
                                    else out, dtype=np.float64))


@pytest.mark.parametrize("measure", ["value", "valuation", "delta", "gamma"])
@pytest.mark.parametrize("case", list(CASES))
def test_leg_measure_matches_jax(engines, case, measure):
    ref = _call(engines, "adrates_tpu", case, measure)
    got = _call(engines, "adrates_torch", case, measure)
    r, g = _array(ref), _array(got)
    assert g.shape == r.shape
    np.testing.assert_allclose(g, r, rtol=0,
                               atol=max(1e-10 * np.abs(r).max(), 1e-9))
    if measure in ("delta", "gamma", "valuation"):
        assert type(got).__name__ == type(ref).__name__
        assert got.currency.name == ref.currency.name
    if measure in ("delta", "gamma"):
        assert got.tenors == ref.tenors
        assert got.curve_type.name == ref.curve_type.name


@pytest.mark.parametrize("curve", ["quoted", "tiny_first_period"])
def test_build_curve_ad_matches_jax(engines, curve):
    if curve == "quoted":
        args = (RATES, TIMES, FRACS)
    else:
        args = ([0.04], [1.004], [[0.004, 1.0]])
    t_j, d_j = (np.asarray(x) for x in
                engines["adrates_tpu"]["engine"].build_curve_ad(*args))
    t_t, d_t = (x.numpy() for x in
                engines["adrates_torch"]["engine"].build_curve_ad(*args))
    np.testing.assert_array_equal(t_t, t_j)
    np.testing.assert_allclose(d_t, d_j, rtol=0, atol=1e-15)
    assert t_t[0] == 0.0 and d_t[0] == 1.0


def test_delta_matches_fd(engines):
    eng = engines["adrates_torch"]["engine"]
    from adrates_torch.utils import Date, InterpTypes
    fixed, flt = _legs("adrates_torch", 0.048, 3)
    v, it = Date(1, 1, 2024), InterpTypes.FLAT_FWD_RATES
    eps = 1e-7
    for leg, val, dl in ((fixed, eng.value_fixed_leg, eng.delta_fixed_leg),
                         (flt, eng.value_float_leg, eng.delta_float_leg)):
        delta = dl(RATES, TIMES, FRACS, leg, v, it).risk_ladder
        for i in range(len(RATES)):
            up, dn = list(RATES), list(RATES)
            up[i] += eps
            dn[i] -= eps
            fd = (float(val(up, TIMES, FRACS, leg, v, it))
                  - float(val(dn, TIMES, FRACS, leg, v, it))) / (2 * eps)
            assert delta[i] == pytest.approx(fd * 1e-4, abs=2e-4)


def test_par_netting_and_gamma_symmetry(engines):
    eng = engines["adrates_torch"]["engine"]
    from adrates_torch.utils import Date, InterpTypes
    fixed, flt = _legs("adrates_torch", RATES[2], 3)
    v, it = Date(1, 1, 2024), InterpTypes.FLAT_FWD_RATES
    pv = float(eng.value_fixed_leg(RATES, TIMES, FRACS, fixed, v, it)) \
        + float(eng.value_float_leg(RATES, TIMES, FRACS, flt, v, it))
    assert abs(pv) < 1e-4
    g = eng.gamma_float_leg(RATES, TIMES, FRACS, flt, v, it).risk_ladder
    np.testing.assert_allclose(g, g.T, rtol=0, atol=1e-12)
