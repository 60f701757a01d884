"""The port's bond and FRN analytics against adrates_tpu's on the CPU.

On the credit model of ``torch_cases`` with its curves on FLAT_FWD_RATES
and on fitted schemes (USD NATCUBIC_ZERO_RATES, GBP PCHIP_LOG_DISCOUNT):
the bond's current yield, durations, convexity, dv01, cs01, g- and
i-spreads, key-rate durations (from the engine's delta ladder) and the
amortization helpers, on a bullet and an amortizing bond; the FRN's
modified duration and dv01, single and dual curve with a discount
margin; and both instruments' printed payment and valuation tables.

Tolerance: rtol 1e-10 (the analytics run Brent root finds and 1bp
bumps on the host); the printed tables exactly."""

import importlib

import numpy as np
import pytest

import adrates_tpu  # noqa: F401 — enables x64 for the JAX side
import torch_cases as tc

PKGS = ("adrates_tpu", "adrates_torch")
SCHEMES = {"flat": None,
           "fitted": {"USD_OIS_SOFR": "NATCUBIC_ZERO_RATES",
                      "GBP_OIS_SONIA": "PCHIP_LOG_DISCOUNT"}}


@pytest.fixture(scope="module", params=list(SCHEMES))
def models(request):
    return {pkg: tc.build_credit_model(pkg, SCHEMES[request.param])
            for pkg in PKGS}


def _bonds(pkg, model):
    u = importlib.import_module(f"{pkg}.utils")
    credit = importlib.import_module(f"{pkg}.trades.credit")
    v = model.value_dt
    D, F, Y = u.DayCountTypes, u.FrequencyTypes, u.CurrencyTypes
    return [credit.Bond(v.add_months(-31).add_days(9), "7Y", 0.04,
                        F.SEMI_ANNUAL, D.THIRTY_360_BOND, Y.USD,
                        face_value=1e6),
            credit.Bond(v.add_months(-9).add_days(21), "5Y", 0.035,
                        F.ANNUAL, D.ACT_365F, Y.GBP, face_value=5e6,
                        amortization_schedule=[4e6, 3e6, 2e6, 1e6, 0.0])]


def _frns(pkg, model):
    u = importlib.import_module(f"{pkg}.utils")
    credit = importlib.import_module(f"{pkg}.trades.credit")
    v = model.value_dt
    D, F, C, Y = (u.DayCountTypes, u.FrequencyTypes, u.CurveTypes,
                  u.CurrencyTypes)
    return [credit.FRN(v.add_months(1).add_days(11), "7Y", 0.002,
                       F.SEMI_ANNUAL, D.ACT_365F, Y.GBP, C.GBP_OIS_SONIA,
                       face_value=3e6, cap_rate=0.045, floor_rate=0.02),
            credit.FRN(v.add_months(-3), "3Y", 0.002, F.QUARTERLY,
                       D.ACT_360, Y.USD, C.GBP_OIS_SONIA,
                       face_value=3e6)]


def _bond_analytics(pkg, model):
    curves = model.curves
    v = model.value_dt
    later = v.add_months(2).add_days(5)
    out = []
    for bond in _bonds(pkg, model):
        disc = curves["USD_OIS_SOFR"] if bond._currency.name == "USD" \
            else curves["GBP_OIS_SONIA"]
        clean = bond.clean_price(v, disc)
        out += [bond.current_yield(),
                bond.duration(v, disc), bond.duration(v, disc, "macaulay"),
                bond.duration(later, disc, z_spread=0.001),
                bond.convexity(v, disc), bond.convexity(v, disc, 0.002),
                bond.dv01(v, disc), bond.dv01(v, disc, 0.001),
                bond.cs01(v, disc),
                bond.g_spread(v, curves["GBP_OIS_SONIA"], clean - 0.4),
                bond.i_spread(v, disc, clean + 0.3)]
    out += list(_bonds(pkg, model)[0].generate_equal_principal_schedule(
        1e6, 8))
    B = type(_bonds(pkg, model)[0])
    F = importlib.import_module(f"{pkg}.utils").FrequencyTypes
    out += list(B.generate_annuity_schedule(1e6, 10, 0.05, F.SEMI_ANNUAL))
    out += list(B.generate_annuity_schedule(1e6, 4, 0.0, F.ANNUAL))
    return [float(x) for x in out]


def test_bond_analytics_match_jax(models):
    vals = [_bond_analytics(pkg, models[pkg]) for pkg in PKGS]
    np.testing.assert_allclose(vals[1], vals[0], rtol=1e-10, atol=1e-12)


def test_bond_key_rate_durations_match_jax(models):
    """Key-rate durations: -delta / price x 1e4 per tenor of the bond's
    currency curve, from the engine (the port's on the CPU)."""
    out = []
    for pkg in PKGS:
        bond = _bonds(pkg, models[pkg])[1]
        kw = {} if pkg == "adrates_tpu" else dict(device="cpu")
        out.append(bond.key_rate_durations(models[pkg], **kw))
    assert list(out[1]) == list(out[0])
    np.testing.assert_allclose(list(out[1].values()), list(out[0].values()),
                               rtol=1e-10, atol=1e-12)


def test_frn_analytics_match_jax(models):
    vals = []
    for pkg in PKGS:
        m = models[pkg]
        gbp, usd = m.curves["GBP_OIS_SONIA"], m.curves["USD_OIS_SOFR"]
        v = m.value_dt
        single, dual = _frns(pkg, m)
        vals.append([
            single.modified_duration(v, gbp),
            single.modified_duration(v, gbp, gbp, 0.003,
                                     v.add_months(1)),
            single.dv01(v, gbp), single.dv01(v, gbp, gbp, 0.001),
            dual.modified_duration(v, usd, gbp),
            dual.dv01(v, usd, gbp, 0.002)])
    np.testing.assert_allclose(vals[1], vals[0], rtol=1e-10, atol=1e-12)


def test_printed_tables_match_jax(models, capsys):
    text = []
    for pkg in PKGS:
        m = models[pkg]
        gbp, usd = m.curves["GBP_OIS_SONIA"], m.curves["USD_OIS_SOFR"]
        v = m.value_dt
        for bond in _bonds(pkg, m):
            bond.print_payments()
            bond.print_valuation(v, usd if bond._currency.name == "USD"
                                 else gbp, 0.001)
        for frn in _frns(pkg, m):
            frn.print_payments()
            frn.value(v, gbp, gbp)
            frn.print_valuation()
        text.append(capsys.readouterr().out)
    assert text[1] == text[0]
    assert "CLEAN PRICE" in text[1]


def test_frn_print_valuation_needs_a_value(models):
    from adrates_torch.utils import LibError
    frn = _frns("adrates_torch", models["adrates_torch"])[0]
    with pytest.raises(LibError, match="call value"):
        frn.print_valuation()
