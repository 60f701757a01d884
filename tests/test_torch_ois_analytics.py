"""The port's OIS host analytics and the OIS and basis-swap print tables
against adrates_tpu's on the CPU.

``OIS.pv01`` / ``ir01`` / ``swap_rate`` on the quick start's 10Y OIS (on
all eight interpolation schemes), a pay-fixed and a forward-starting
OIS on the quick start's 13-pillar GBP curve, and the seasoned GBP OIS
under USD collateral of ``torch_cases.build_xccy_trades`` with the
GBP/USD XCCY curve as its discount curve; the reference's ``swap_rate``
convention (float PV / pv01 / notional: -c/100 for a receive-fixed swap
at par coupon c, +c/100 paying fixed), pinned in both packages on two
pillar swaps of the bootstrap; the OIS's ``print_payments`` /
``print_fixed_leg_pv`` / ``print_float_leg_pv`` and the basis swap's
``print_payments`` / ``print_valuation`` as captured text; and the
valuation tables' refusal before ``value``.

Tolerance: rtol 1e-10 (host numpy on the same curves; ir01 is a
difference of two bumped PVs); the printed tables exactly."""

import importlib
import re

import numpy as np
import pytest

import adrates_tpu  # noqa: F401 — enables x64 for the JAX side
import torch_cases as tc

PKGS = ("adrates_tpu", "adrates_torch")
SCHEMES = ["FLAT_FWD_RATES", "LINEAR_ZERO_RATES", "LINEAR_FWD_RATES",
           "PCHIP_LOG_DISCOUNT", "PCHIP_ZERO_RATES", "NATCUBIC_LOG_DISCOUNT",
           "NATCUBIC_ZERO_RATES", "FINCUBIC_ZERO_RATES"]


def _u(pkg):
    return importlib.import_module(f"{pkg}.utils")


def _ois(pkg, start, tenor, leg, cpn, freq="ANNUAL", notional=1e7):
    """A GBP OIS on the quick start's conventions."""
    u = _u(pkg)
    OIS = importlib.import_module(f"{pkg}.trades.rates").OIS
    return OIS(start, tenor, getattr(u.SwapTypes, leg), cpn,
               getattr(u.FrequencyTypes, freq), u.DayCountTypes.ACT_365F,
               u.CurveTypes.GBP_OIS_SONIA, u.CurrencyTypes.GBP,
               notional=notional, float_dc_type=u.DayCountTypes.ACT_365F,
               bd_type=u.BusDayAdjustTypes.MODIFIED_FOLLOWING)


def _analytics(swap, v, curve):
    return [swap.pv01(v, curve), swap.ir01(v, curve),
            swap.swap_rate(v, curve)]


def _quickstart_case(pkg, interp="LINEAR_ZERO_RATES"):
    m = tc.quickstart_gbp_model(pkg, interp)
    return tc.quickstart_ten_year(pkg), m.value_dt, \
        m.curves["GBP_OIS_SONIA"]


def _pay_fixed_case(pkg):
    m = tc.quickstart_gbp_model(pkg)
    v = m.value_dt
    return _ois(pkg, v, "7Y", "PAY", 0.0412, "SEMI_ANNUAL", 2.5e7), v, \
        m.curves["GBP_OIS_SONIA"]


def _forward_start_case(pkg):
    m = tc.quickstart_gbp_model(pkg)
    v = m.value_dt
    return _ois(pkg, v.add_months(18).add_days(3), "12Y", "RECEIVE",
                0.0365), v, m.curves["GBP_OIS_SONIA"]


def _collateral_case(pkg):
    m = tc.build_xccy_model(pkg)
    trades, coll = tc.build_xccy_trades(pkg, m)
    i = next(k for k, c in enumerate(coll) if c is not None)
    return trades[i], m.value_dt, m.curves["GBP_USD_XCCY"]


CASES = {"quickstart": _quickstart_case, "pay_fixed": _pay_fixed_case,
         "forward_start": _forward_start_case,
         "usd_collateral": _collateral_case}


@pytest.mark.parametrize("case", list(CASES))
def test_analytics_match_jax(case):
    got = [_analytics(*CASES[case](pkg)) for pkg in PKGS]
    np.testing.assert_allclose(got[1], got[0], rtol=1e-10, atol=0)
    assert got[1][0] > 0 and all(np.isfinite(got[1]))


@pytest.mark.parametrize("interp", SCHEMES)
def test_analytics_match_jax_on_every_scheme(interp):
    got = [_analytics(*_quickstart_case(pkg, interp)) for pkg in PKGS]
    np.testing.assert_allclose(got[1], got[0], rtol=1e-10, atol=0)


def test_swap_rate_with_a_first_fixing_matches_jax():
    got = []
    for pkg in PKGS:
        swap, v, curve = _collateral_case(pkg)
        got.append(swap.swap_rate(v, curve, first_fixing_rate=0.0521))
    np.testing.assert_allclose(got[1], got[0], rtol=1e-10, atol=0)


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("leg,tenor,cpn,sign",
                         [("RECEIVE", "10Y", 0.0387, -1.0),
                          ("PAY", "5Y", 0.0393, 1.0)])
def test_swap_rate_is_the_signed_par_coupon_over_100(pkg, leg, tenor, cpn,
                                                     sign):
    """The reference's convention, reproduced: a pillar swap of the
    bootstrap is at par, and its swap_rate is -c/100 receiving fixed and
    +c/100 paying it."""
    m = tc.quickstart_gbp_model(pkg)
    v, curve = m.value_dt, m.curves["GBP_OIS_SONIA"]
    swap = _ois(pkg, v, tenor, leg, cpn)
    assert abs(swap.value(v, curve)) <= 1e-8 * 1e7
    np.testing.assert_allclose(swap.swap_rate(v, curve), sign * cpn / 100,
                               rtol=1e-10, atol=0)


def _basis_case(pkg):
    m = tc.build_xccy_model(pkg)
    trades, _ = tc.build_xccy_trades(pkg, m)
    swap = next(t for t in trades if type(t).__name__ == "XccyBasisSwap")
    curves = dict(domestic_discount_curve=m.curves["USD_OIS_SOFR"],
                  foreign_discount_curve=m.curves["GBP_OIS_SONIA"],
                  xccy_discount_curve=m.curves["GBP_USD_XCCY"])
    return swap, m.value_dt, curves


def test_printed_tables_match_jax(capsys):
    text = []
    for pkg in PKGS:
        for case in ("quickstart", "forward_start", "usd_collateral"):
            swap, v, curve = CASES[case](pkg)
            swap.print_payments()
            swap.value(v, curve)
            swap.print_fixed_leg_pv()
            swap.print_float_leg_pv()
        basis, v, curves = _basis_case(pkg)
        basis.print_payments()
        basis.value(v, spot_fx=1.27, **curves)
        basis.print_valuation()
        text.append(capsys.readouterr().out)
    assert text[1] == text[0]
    assert text[1].count("DOMESTIC LEG:") == 2
    assert text[1].count("FOREIGN LEG:") == 2


def _rows(text):
    """The data rows of the captured tables (``| 1 | ...``)."""
    return sum(bool(re.match(r"\| \d", line)) for line in text.splitlines())


def test_printed_tables_have_one_row_per_payment(capsys):
    swap, v, curve = _quickstart_case("adrates_torch")
    basis, bv, curves = _basis_case("adrates_torch")
    swap.value(v, curve)
    basis.value(bv, spot_fx=1.27, **curves)
    fixed, flt = swap._fixed_leg, swap._float_leg
    dom, fgn = basis._domestic_leg, basis._foreign_leg
    for method, n in ((swap.print_payments, len(fixed._payment_dts)
                       + len(flt._payment_dts)),
                      (swap.print_fixed_leg_pv, len(fixed._payment_dts)),
                      (swap.print_float_leg_pv, len(flt._payment_dts)),
                      (basis.print_payments, len(dom._payment_dts)
                       + len(fgn._payment_dts)),
                      (basis.print_valuation, len(dom._payment_dts)
                       + len(fgn._payment_dts))):
        method()
        assert _rows(capsys.readouterr().out) == n > 0


@pytest.mark.parametrize("method", ["print_fixed_leg_pv",
                                    "print_float_leg_pv",
                                    "print_valuation"])
def test_valuation_tables_need_a_value(method):
    errors = []
    for pkg in PKGS:
        trade = (_basis_case(pkg) if method == "print_valuation"
                 else _quickstart_case(pkg))[0]
        with pytest.raises(_u(pkg).LibError) as err:
            getattr(trade, method)()
        errors.append(str(err.value))
    assert errors[1] == errors[0]
    assert "call value" in errors[1]
