"""The port's fixed-leg XCCY swaps (fix-float and fix-fix) against
adrates_tpu on the CPU: host values, the compiled rows with their manual
notional exchanges (ACT_ACT_ISDA times on the domestic leg, ACT/365F on
the foreign leg, discounted on the XCCY curve; an exchange at t = 0
still settles, a past one does not), and the book's pvs, delta and gamma
at 3 scenarios, tiled x2, on the structured split, the generic split and
the staged path.

Tolerances: host values rtol 1e-12 (static against dynamic interpolation
plans); compiled tables exactly or 1e-15 relative; book outputs 1e-10 x
max|ref|.
"""

import dataclasses
import importlib

import numpy as np
import pytest

import adrates_tpu  # noqa: F401 — enables x64 for the JAX side
import torch_cases as cases
from adrates_tpu.parallel import multibook as jmb
from adrates_torch.parallel import multibook as tmb

PKGS = ("adrates_tpu", "adrates_torch")


@pytest.fixture(scope="module")
def models():
    return {pkg: cases.build_credit_model(pkg) for pkg in PKGS}


@pytest.fixture(scope="module")
def books(models):
    """Per package (base, tiled) of the fixed-XCCY trades plus a basis
    swap and a USD OIS in USD, and the JAX tiled book's outputs."""
    out = {}
    for pkg in PKGS:
        m = models[pkg]
        u = importlib.import_module(f"{pkg}.utils")
        trades = cases.fixed_xccy_trades(pkg, m) \
            + cases.credit_trades_for(pkg, m)[1:3]
        out[pkg] = cases.compile_tiled(pkg, m, trades,
                                       base_currency=u.CurrencyTypes.USD)
    jt = out["adrates_tpu"][1]
    q0 = jt.basket.quotes0
    sh = cases.shocks(jt.basket.n_quotes)
    ref = {k: np.asarray(v)
           for k, v in jmb.make_multibook_fn(jt)(q0, sh).items()}
    return out, q0, sh, ref


def test_host_values(models):
    vals = []
    for pkg in PKGS:
        m = models[pkg]
        usd, gbp = m.curves["USD_OIS_SOFR"], m.curves["GBP_OIS_SONIA"]
        xccy = m.curves["GBP_USD_XCCY"]
        vals.append([t.value(m.value_dt, usd, gbp, xccy, 1.27)
                     for t in cases.fixed_xccy_trades(pkg, m)])
    np.testing.assert_allclose(vals[1], vals[0], rtol=1e-12)


def test_finds_its_xccy_curve(models):
    from adrates_torch.trades.rates.xccy_curve import find_xccy_curve
    m = models["adrates_torch"]
    for t in cases.fixed_xccy_trades("adrates_torch", m):
        assert find_xccy_curve(m, t)[0] == "GBP_USD_XCCY"


@pytest.mark.parametrize("field", [f.name for f in
                                   dataclasses.fields(tmb.MultiBookRows)])
def test_rows(books, field):
    out, *_ = books
    jb, tb = out["adrates_tpu"][0], out["adrates_torch"][0]
    assert len(jb.buckets) == len(tb.buckets)
    for a, b in zip(jb.buckets, tb.buckets):
        x, y = np.asarray(getattr(a, field)), getattr(b, field)
        np.testing.assert_allclose(y, x, rtol=1e-15, atol=0)


def test_manual_exchanges(models):
    """Each fixed leg's row ends with its two exchanges: -N at the
    effective time and +N at maturity, live from t >= 0, the foreign one
    in domestic (USD) units at the XCCY curve's spot."""
    from adrates_torch.utils import CurrencyTypes
    m = models["adrates_torch"]
    basket = tmb.CurveBasket(m)
    trades = cases.fixed_xccy_trades("adrates_torch", m)
    today, _, seasoned, fixfix, _ = trades
    for t in (today, seasoned, fixfix):
        rows = tmb._rows_for_instrument(t, m, basket, CurrencyTypes.USD,
                                        m.value_dt, 0, [])
        legs = [rows[0]] + ([rows[1]] if t is fixfix else [])
        for row, fx, n in zip(legs, (1.0, 1.27),
                              (t._domestic_notional,
                               t._foreign_notional)):
            eff_t, mat_t = row["fix_t"][-2:]
            sign = np.sign(row["fix_amt"][-1])
            np.testing.assert_allclose(row["fix_amt"][-2:],
                                       [-sign * fx * n, sign * fx * n],
                                       rtol=1e-15)
            assert row["fix_m"][-2:] == [1.0 if eff_t >= 0 else 0.0, 1.0]
            if t is today:
                assert eff_t == 0.0 and row["fix_m"][-2] == 1.0
            if t is seasoned:
                assert eff_t < 0.0 and row["fix_m"][-2] == 0.0


@pytest.mark.parametrize("route", ["structured", "generic", "staged"])
def test_book_matches_jax(models, books, route):
    out, q0, sh, ref = books
    tiled = out["adrates_torch"][1]
    if route == "generic":
        from adrates_torch.utils import CurrencyTypes
        m = models["adrates_torch"]
        trades = cases.fixed_xccy_trades("adrates_torch", m) \
            + cases.credit_trades_for("adrates_torch", m)[1:3]
        _, tiled = cases.compile_tiled("adrates_torch", m, trades,
                                       base_currency=CurrencyTypes.USD,
                                       batch_curves=False)
        fn = tmb.make_multibook_fn(tiled, "cpu")
        assert not fn.structured
    elif route == "staged":
        fn = tmb.make_staged_multibook_fn(tiled, "cpu")
    else:
        fn = tmb.make_multibook_fn(tiled, "cpu")
    got = {k: v.numpy() for k, v in fn(q0, sh).items()}
    for k in ("pvs", "delta", "gamma"):
        np.testing.assert_allclose(got[k], ref[k], rtol=0,
                                   atol=1e-10 * np.abs(ref[k]).max(),
                                   err_msg=k)
